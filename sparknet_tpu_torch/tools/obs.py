"""obs: the telemetry plane's CLI: merge trace shards, roll up, smoke.

    python -m sparknet_tpu_torch.tools.obs merge TRACE_DIR [--out FILE]
        [--metrics-dir DIR] [--check] [--expect-ranks N]
    python -m sparknet_tpu_torch.tools.obs smoke [--out FILE]
        [--device cuda|cpu]

The port's copy of the root ``tools/obs.py``.  ``merge`` joins the
per-rank Chrome-trace JSONL shards a run wrote under
``SPARKNET_TRACE_DIR`` (trainer rounds, feed stages, checkpoint writes,
serving batches, every rank and incarnation) into one clock-aligned
timeline, prints a span and metrics rollup (the metrics folded from
``metrics_rank*.json`` snapshots by ``telemetry.fold_snapshots``), and
with ``--check`` validates it: spans present, ranks covered, run and
rank correlation IDs on every span, non-negative rebased timestamps,
time-sorted.  Shards stamp epoch microseconds, so alignment across
processes is one global rebase.

``smoke`` is the gate, with the port's ``--device`` (the card unless
the caller asks for the CPU): two single-process runs of
``tools/train_cifar`` (cifar10_quick, 2 ``sync`` workers, 2 rounds) that
share one ``SPARKNET_RUN_ID`` with ranks 0 and 1, side by side with a
live ``tools/serve`` (lenet, rank 9) whose ``GET /metrics`` must parse as
Prometheus text; then ``merge --check`` must validate the merged trace
with ``trainer.round`` spans from both training ranks.  (The JAX smoke
trains through ``tests/multihost_driver.py``; the port's runs one of its
own entry points instead.)  The children inherit the environment but
its ``SPARKNET_*`` knobs, so they find the kernels the parent built
under ``sparknet_tpu_torch/_build`` and the device it was given.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import re
import shutil
import signal
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


# ---------------------------------------------------------------------------
# Shard loading and merge
# ---------------------------------------------------------------------------

def load_shards(directory: str) -> tuple[list[dict], list[str]]:
    """Every parseable event of every trace_*.jsonl under ``directory``
    (recursive).  A torn final line (the process died mid-flush) is
    skipped, not fatal."""
    shards = sorted(glob.glob(os.path.join(directory, "**",
                                           "trace_*.jsonl"),
                              recursive=True))
    events: list[dict] = []
    for path in shards:
        try:
            with open(path) as f:
                for line in f:
                    line = line.strip()
                    if not line:
                        continue
                    try:
                        events.append(json.loads(line))
                    except json.JSONDecodeError:
                        continue
        except OSError:
            continue
    return events, shards


def merge_events(events: list[dict]) -> dict:
    """Rebase every timestamped event to the run's earliest microsecond
    and sort: the clock alignment step."""
    timed = [e for e in events if "ts" in e]
    meta = [e for e in events if "ts" not in e]
    t0 = min((e["ts"] for e in timed), default=0)
    out = []
    for e in timed:
        e = dict(e)
        e["ts"] = e["ts"] - t0
        out.append(e)
    out.sort(key=lambda e: (e["ts"], e.get("dur", 0)))
    return {"traceEvents": meta + out, "displayTimeUnit": "ms",
            "otherData": {"epoch_us_origin": t0}}


def trace_rollup(events: list[dict]) -> dict:
    """Per-span-name counts and durations and per-rank event counts: the
    merge command's printed summary."""
    spans: dict[str, dict] = {}
    ranks: dict[str, int] = {}
    runs: set = set()
    flights = 0
    for e in events:
        args = e.get("args") or {}
        if "rank" in args:
            ranks[str(args["rank"])] = ranks.get(str(args["rank"]), 0) + 1
        if "run" in args:
            runs.add(str(args["run"]))
        if e.get("ph") == "X":
            s = spans.setdefault(e.get("name", "?"),
                                 {"count": 0, "total_us": 0, "max_us": 0})
            s["count"] += 1
            dur = int(e.get("dur", 0))
            s["total_us"] += dur
            s["max_us"] = max(s["max_us"], dur)
        elif e.get("cat") == "flight":
            flights += 1
    return {"spans": spans, "ranks": ranks, "runs": sorted(runs),
            "flight_events": flights}


def fold_metrics_dir(directory: str) -> dict:
    from ..utils.telemetry import fold_snapshots
    paths = glob.glob(os.path.join(directory, "**", "metrics_rank*.json"),
                      recursive=True)
    return fold_snapshots(sorted(paths))


def check_trace(events: list[dict], rollup: dict,
                expect_ranks: int) -> list[str]:
    """The ``--check`` validations: the trace must be usable evidence,
    not just a file that exists."""
    failures: list[str] = []
    spans = [e for e in events if e.get("ph") == "X"]
    if not spans:
        failures.append("no complete spans (ph=X) in any shard")
    if len(rollup["ranks"]) < expect_ranks:
        failures.append(f"spans from {len(rollup['ranks'])} rank(s) "
                        f"{sorted(rollup['ranks'])}, expected >= "
                        f"{expect_ranks}")
    bad_corr = sum(1 for e in spans
                   if "run" not in (e.get("args") or {})
                   or "rank" not in (e.get("args") or {}))
    if bad_corr:
        failures.append(f"{bad_corr} span(s) missing run/rank "
                        f"correlation IDs")
    bad_ts = sum(1 for e in events
                 if "ts" in e and (e["ts"] < 0 or e.get("dur", 0) < 0))
    if bad_ts:
        failures.append(f"{bad_ts} event(s) with negative rebased ts or "
                        f"negative dur: clocks are not aligned")
    prev = -1
    for e in events:
        ts = e.get("ts")
        if ts is None:
            continue
        if ts < prev:
            failures.append("merged events are not time-sorted")
            break
        prev = ts
    return failures


def cmd_merge(args) -> int:
    events, shards = load_shards(args.trace_dir)
    if not shards:
        print(f"obs merge: no trace_*.jsonl shards under "
              f"{args.trace_dir!r}", file=sys.stderr)
        return 2
    merged = merge_events(events)
    rollup = trace_rollup(merged["traceEvents"])
    out = args.out or os.path.join(args.trace_dir, "trace_merged.json")
    with open(out, "w") as f:
        json.dump(merged, f)
    print(f"obs merge: {len(shards)} shard(s), "
          f"{len(merged['traceEvents'])} events -> {out}")
    print(f"  runs: {', '.join(rollup['runs']) or '-'}")
    print("  ranks: " + ", ".join(
        f"{r} ({n} ev)" for r, n in sorted(rollup["ranks"].items())))
    if rollup["flight_events"]:
        print(f"  flight-recorder events on the timeline: "
              f"{rollup['flight_events']}")
    for name, s in sorted(rollup["spans"].items(),
                          key=lambda kv: -kv[1]["total_us"]):
        print(f"  span {name:<24} x{s['count']:<6} "
              f"total {s['total_us'] / 1e6:.3f}s "
              f"max {s['max_us'] / 1e3:.1f}ms")
    metrics = fold_metrics_dir(args.metrics_dir or args.trace_dir)
    if metrics:
        print("  metrics rollup:")
        for name, m in sorted(metrics.items()):
            for s in m["samples"]:
                lbl = ",".join(f"{k}={v}" for k, v in
                               sorted(s["labels"].items()))
                if m["kind"] == "histogram":
                    print(f"    {name}{{{lbl}}} count={s['count']} "
                          f"sum={s['sum']:.4g}")
                else:
                    print(f"    {name}{{{lbl}}} {s['value']:g}")
    if args.check:
        failures = check_trace(merged["traceEvents"], rollup,
                               args.expect_ranks)
        if failures:
            print("obs merge: CHECK FAILED:", file=sys.stderr)
            for msg in failures:
                print(f"  - {msg}", file=sys.stderr)
            return 1
        print(f"obs merge: check OK ({len(rollup['ranks'])} ranks, "
              f"{sum(s['count'] for s in rollup['spans'].values())} spans)")
    return 0


# ---------------------------------------------------------------------------
# Prometheus text (the /metrics half of the smoke)
# ---------------------------------------------------------------------------

_PROM_LINE = re.compile(
    r"^([a-zA-Z_:][a-zA-Z0-9_:]*)(\{[^}]*\})?\s+"
    r"([-+]?(?:[0-9]*\.?[0-9]+(?:[eE][-+]?[0-9]+)?|Inf|NaN))$")


def parse_prometheus(text: str) -> dict[str, list[tuple[str, float]]]:
    """Strict-enough parser of the text exposition format: every
    non-comment, non-blank line must be ``name{labels} value``.  Raises
    ValueError on the first malformed line; returns name -> samples."""
    out: dict[str, list[tuple[str, float]]] = {}
    for i, line in enumerate(text.splitlines(), 1):
        line = line.rstrip()
        if not line or line.startswith("#"):
            continue
        m = _PROM_LINE.match(line)
        if not m:
            raise ValueError(f"line {i} is not Prometheus text: {line!r}")
        name, labels, value = m.group(1), m.group(2) or "", m.group(3)
        out.setdefault(name, []).append((labels, float(value)))
    return out


# ---------------------------------------------------------------------------
# The smoke
# ---------------------------------------------------------------------------

SMOKE_METRICS = ("serve_queue_depth", "serve_p99_ms",
                 "serve_request_seconds_bucket", "serve_completed_total")


def _scrubbed_env(**extra: str) -> dict:
    """The parent's environment without its ``SPARKNET_*`` knobs, plus
    ``extra``: the children keep the device settings and find the kernels
    the parent built (the checkout's ``sparknet_tpu_torch/_build``)."""
    env = {k: v for k, v in os.environ.items()
           if not k.startswith("SPARKNET_")}
    env.update(extra)
    return env


def _http(url: str, payload: dict | None = None,
          timeout: float = 30.0) -> dict | str:
    import urllib.request
    if payload is None:
        req = urllib.request.Request(url)
    else:
        req = urllib.request.Request(
            url, data=json.dumps(payload).encode(),
            headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=timeout) as resp:
        body = resp.read().decode()
        ctype = resp.headers.get("Content-Type", "")
    return json.loads(body) if "json" in ctype else body


SMOKE_SOLVER = """net: "{net}"
test_iter: 1
test_interval: 2
base_lr: 0.001
momentum: 0.9
weight_decay: 0.004
lr_policy: "fixed"
max_iter: 2
"""


def _smoke_solver(work: str) -> str:
    """cifar10_quick at its published widths and batch, written into
    ``work`` with a 2-iteration solver."""
    from ..models import cifar10_quick
    from ..proto import save_net_prototxt
    net = os.path.join(work, "cifar10_quick_train_test.prototxt")
    save_net_prototxt(cifar10_quick(100, 100), net)
    solver = os.path.join(work, "cifar10_quick_solver.prototxt")
    with open(solver, "w") as f:
        f.write(SMOKE_SOLVER.format(net=net))
    return solver


def _train_cmd(work: str, solver: str, rank: int, device: str) -> list[str]:
    """2 rounds of 2 ``sync`` workers (τ=1), then one test pass."""
    return [sys.executable, "-m", "sparknet_tpu_torch.tools.train_cifar",
            "--solver", solver, "--synthetic", "--workers", "2",
            "--strategy", "sync", "--tau", "1",
            "--out", os.path.join(work, f"traj{rank}.json"),
            "--device", device]


def _serve_leg(proc: subprocess.Popen, failures: list[str],
               verdict: dict) -> None:
    """Wait for the server's ready line, classify once, and parse
    ``/metrics``."""
    import base64

    import numpy as np
    url = None
    deadline = time.monotonic() + 180
    while time.monotonic() < deadline:
        line = proc.stdout.readline()
        if line.startswith("serving on "):
            url = line.split()[2]
            break
        if proc.poll() is not None:
            break
    if not url:
        failures.append("tools/serve never printed its ready line")
        return
    x = np.zeros((1, 28, 28), np.float32)
    res = _http(f"{url}/v1/classify", {
        "model": "lenet", "tenant": "obssmoke", "shape": [1, 28, 28],
        "dtype": "float32",
        "data_b64": base64.b64encode(x.tobytes()).decode()})
    if not isinstance(res, dict) or "probs" not in res:
        failures.append(f"classify answer malformed: {res!r:.200}")
    text = _http(f"{url}/metrics")
    try:
        samples = parse_prometheus(str(text))
    except ValueError as e:
        failures.append(f"/metrics is not Prometheus text: {e}")
        samples = {}
    for need in SMOKE_METRICS:
        if need not in samples:
            failures.append(f"/metrics missing {need}")
    verdict["metrics_families"] = len(samples)


def cmd_smoke(args) -> int:
    from ..utils.device import resolve_device
    device = str(resolve_device(args.device))
    t_start = time.monotonic()
    work = tempfile.mkdtemp(prefix="sparknet_obssmoke_")
    trace_dir = os.path.join(work, "trace")
    snap_dir = os.path.join(work, "metrics")
    verdict: dict = {"ok": False, "trace_dir": trace_dir}
    failures: list[str] = []

    # leg 1: two single-process training runs sharing one run id (the
    # shard and correlation plumbing, not a collective), side by side
    # with leg 2's server
    solver = _smoke_solver(work)
    trainers = []
    for rank in (0, 1):
        env = _scrubbed_env(
            SPARKNET_TRACE_DIR=trace_dir, SPARKNET_METRICS_SNAP=snap_dir,
            SPARKNET_METRICS_SNAP_S="0", SPARKNET_RUN_ID="obssmoke",
            SPARKNET_TELEMETRY_RANK=str(rank))
        trainers.append(subprocess.Popen(
            _train_cmd(work, solver, rank, device), cwd=ROOT, env=env,
            stdout=subprocess.DEVNULL, stderr=subprocess.PIPE, text=True))
    # leg 2: a live server over HTTP whose /metrics must parse
    proc = subprocess.Popen(
        [sys.executable, "-m", "sparknet_tpu_torch.tools.serve",
         "--models", "lenet", "--port", "0", "--shapes", "1,4",
         "--max-delay-ms", "2", "--dtype", "f32", "--device", device],
        cwd=ROOT, env=_scrubbed_env(
            SPARKNET_TRACE_DIR=trace_dir, SPARKNET_RUN_ID="obssmoke",
            SPARKNET_TELEMETRY_RANK="9"),   # 0 and 1 are training
        stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
    try:
        _serve_leg(proc, failures, verdict)
    finally:
        if proc.poll() is None:
            proc.send_signal(signal.SIGTERM)
            try:
                proc.wait(timeout=20)
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait()
        for rank, p in enumerate(trainers):
            try:
                _, err = p.communicate(timeout=300)
            except subprocess.TimeoutExpired:
                p.kill()
                _, err = p.communicate()
            if p.returncode != 0:
                failures.append(f"training rank {rank} failed rc="
                                f"{p.returncode}: {err[-500:]}")

    # leg 3: the merged trace must validate
    events, shards = load_shards(trace_dir)
    verdict["shards"] = len(shards)
    if not shards:
        failures.append("no trace shards were written")
    else:
        merged = merge_events(events)
        rollup = trace_rollup(merged["traceEvents"])
        failures.extend(check_trace(merged["traceEvents"], rollup,
                                    expect_ranks=2))
        if "trainer.round" not in rollup["spans"]:
            failures.append("no trainer.round spans in the merged trace")
        training_ranks = {str(e.get("args", {}).get("rank"))
                          for e in merged["traceEvents"]
                          if e.get("name") == "trainer.round"}
        if not {"0", "1"} <= training_ranks:
            failures.append(f"trainer.round spans from ranks "
                            f"{sorted(training_ranks)}, want 0 and 1")
        out_path = os.path.join(trace_dir, "trace_merged.json")
        with open(out_path, "w") as f:
            json.dump(merged, f)
        verdict.update(events=len(merged["traceEvents"]),
                       ranks=sorted(rollup["ranks"]),
                       spans={k: v["count"]
                              for k, v in rollup["spans"].items()},
                       merged=out_path)
    verdict["metrics_rollup"] = bool(fold_metrics_dir(snap_dir))

    verdict["failures"] = failures
    verdict["ok"] = not failures
    verdict["elapsed_s"] = round(time.monotonic() - t_start, 1)
    text = json.dumps(verdict, indent=1)
    if args.out:
        with open(args.out, "w") as f:
            f.write(text + "\n")
    print(text)
    if failures:
        print(f"[obssmoke] FAILED: {failures}", file=sys.stderr)
        print(f"[obssmoke] scratch kept at {work}", file=sys.stderr)
        return 1
    print(f"[obssmoke] OK: merged trace and /metrics validated in "
          f"{verdict['elapsed_s']}s", file=sys.stderr)
    shutil.rmtree(work, ignore_errors=True)
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="telemetry plane CLI")
    sub = ap.add_subparsers(dest="cmd", required=True)
    mp = sub.add_parser("merge", help="join per-rank trace shards into "
                                      "one perfetto timeline + rollup")
    mp.add_argument("trace_dir")
    mp.add_argument("--out", default=None,
                    help="merged trace path (default: "
                         "<trace_dir>/trace_merged.json)")
    mp.add_argument("--metrics-dir", default=None,
                    help="fold metrics_rank*.json snapshots from here "
                         "(default: the trace dir)")
    mp.add_argument("--check", action="store_true",
                    help="validate the merged trace (spans present, "
                         "ranks covered, correlation IDs, aligned ts)")
    mp.add_argument("--expect-ranks", type=int, default=1,
                    help="--check: minimum distinct ranks required")
    sp = sub.add_parser("smoke", help="the observability gate")
    sp.add_argument("--out", default=None,
                    help="write the JSON verdict here too")
    sp.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    if args.cmd == "merge":
        return cmd_merge(args)
    return cmd_smoke(args)


if __name__ == "__main__":
    sys.exit(main())
