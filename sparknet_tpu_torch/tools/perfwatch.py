"""perfwatch — the port's performance observatory CLI.

    python -m sparknet_tpu_torch.tools.perfwatch <command> ...

The port's copy of the root ``tools/perfwatch.py``, over the port's own
ledger (``sparknet_tpu_torch/utils/perfledger.py``), which has no
default path: ``--ledger`` names it.

  ingest      append captures to the ledger; ``--backfill`` walks the
              port's own committed captures
              (``sparknet_tpu_torch/profiles/*/op_table.json`` and
              ``tuning.json``).  A JAX-package or TPU capture (the root
              ``profiles/``, ``BENCH_*``/``RESULTS_*`` files, a ``tpu/``
              device) is refused by name.
  regress     compare a fresh capture against its per-(metric,
              fingerprint) baseline band (median + k·MAD over a
              trailing window) and attribute a breach to a stage from
              the stage metrics riding the capture.  Exit 0 = within
              band or not gate-able; exit 1 = regression.
  diff        join two ``op_table.json`` captures by op category and by
              layer, and rank the unfused conv+bias+relu(+pool/LRN)
              chains of the second by reclaimable ms: the fusion
              worklist of ``graph/fusion.py``, the one the ``auto`` plan
              reads.
  trajectory  one row per round tag from the ledger, written as JSON to
              the file ``--out`` names (and as a markdown table to
              ``--md``, spliced between perfwatch markers); it never
              touches ``RESULTS.md``.
  perfgate    a short bench smoke (``python -m sparknet_tpu_torch.bench``
              on lenet) regressed against the ledger, plus a sentinel
              self-test: the same smoke with a slowed feed leg against a
              scratch ledger seeded from the fresh capture must exit
              non-zero, attributed to the decode stage.

Every command that runs the program takes ``--device`` (the card by
default).
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import subprocess
import sys
import time

from ..graph.fusion import fusion_worklist
from ..utils import perfledger as pl

PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REPO = os.path.dirname(PKG)


def _log(msg: str) -> None:
    print(f"[perfwatch] {msg}", file=sys.stderr, flush=True)


# ---------------------------------------------------------------------------
# ingest
# ---------------------------------------------------------------------------

def _git_file_times(path: str) -> tuple[float | None, str | None]:
    """(first-commit epoch, last-touch short sha) for a committed file —
    honest timestamps/provenance for artifacts that predate stamping."""
    rel = os.path.relpath(path, REPO)
    try:
        out = subprocess.run(
            ["git", "log", "--follow", "--diff-filter=A", "--format=%ct",
             "--", rel], cwd=REPO, stdout=subprocess.PIPE,
            stderr=subprocess.DEVNULL, timeout=15)
        lines = out.stdout.decode().split()
        t = float(lines[-1]) if out.returncode == 0 and lines else None
        out = subprocess.run(
            ["git", "log", "-n1", "--format=%h", "--", rel], cwd=REPO,
            stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, timeout=15)
        sha = out.stdout.decode().strip() or None
    except (OSError, subprocess.SubprocessError, ValueError):
        return None, None
    return t, sha


class ForeignCapture(ValueError):
    """A capture of the JAX package or of a TPU offered to the port's
    ledger."""


def _foreign(doc: dict, rel: str) -> str | None:
    """Why ``doc`` (at ``rel``, relative to the repo) is no capture of
    the port, or None: it lies among the JAX package's captures (the root
    ``profiles/``, the root ``BENCH_*``/``RESULTS_*``/``MULTICHIP_*``
    files) or names a TPU device."""
    head = rel.replace(os.sep, "/")
    if head.startswith("profiles/") or (
            "/" not in head and head.startswith(
                ("BENCH_", "RESULTS_", "MULTICHIP_", "SOAK_"))):
        return "a capture of the JAX package"
    fp = ((doc.get("provenance") or {}).get("fingerprint") or {})
    device = str((doc.get("summary") or {}).get("device")
                 or doc.get("device") or fp.get("device") or "")
    if device.lower().startswith("tpu"):
        return f"a TPU capture (device {device!r})"
    return None


def _ingest_file(ledger: pl.PerfLedger, path: str, *,
                 device_hint: str | None = None,
                 round_tag: str | None = None,
                 t: float | None = None, backfill: bool = False) -> int:
    try:
        with open(path) as f:
            doc = json.load(f)
    except (OSError, json.JSONDecodeError) as e:
        _log(f"skip {path}: {e}")
        return 0
    rel = os.path.relpath(os.path.abspath(path), REPO)
    if rel.startswith(".."):
        rel = path
    why = _foreign(doc, rel)
    if why:
        raise ForeignCapture(f"refused {rel}: {why}, not the port's")
    if any(e.get("path") == rel for e in ledger.entries()):
        _log(f"skip {rel}: already in the ledger")
        return 0
    sha = None
    if backfill:
        git_t, sha = _git_file_times(path)
        t = t or git_t
    entries = pl.entries_from_any(doc, rel, round_tag=round_tag, t=t,
                                  device_hint=device_hint)
    if backfill:
        for e in entries:
            if not e.get("sha"):
                e["sha"] = sha
    n = ledger.extend(entries)
    if n:
        _log(f"ingested {rel}: {n} entr{'y' if n == 1 else 'ies'}")
    else:
        _log(f"{rel}: nothing ingestible (failed capture or unknown "
             f"shape)")
    return n


def cmd_ingest(args) -> int:
    ledger = pl.PerfLedger(args.ledger)
    total = 0
    try:
        if args.backfill:
            for name in ("op_table.json", "tuning.json"):
                for path in sorted(glob.glob(
                        os.path.join(PKG, "profiles", "*", name))):
                    total += _ingest_file(ledger, path, backfill=True)
        for path in args.files:
            total += _ingest_file(ledger, path,
                                  device_hint=args.device_hint,
                                  round_tag=args.round)
    except ForeignCapture as e:
        _log(str(e))
        return 2
    _log(f"ledger {ledger.path}: +{total} entries, "
         f"{len(ledger.entries(reload=True))} total, "
         f"{len(ledger.fingerprints())} fingerprints")
    return 0


# ---------------------------------------------------------------------------
# regress
# ---------------------------------------------------------------------------

# stage-metric -> human attribution label (the PR-8 telemetry names the
# operator would grep for)
_STAGE_LABELS = {
    "feed_read_s": "feed.read (feed_stage_seconds{stage=read})",
    "feed_decode_s": "feed.decode (feed_stage_seconds{stage=decode})",
    "feed_transform_s":
        "feed.transform (feed_stage_seconds{stage=transform})",
    "feed_device_put_s":
        "feed.device_put (feed_stage_seconds{stage=device_put})",
    "feed_alone_s": "feed (feed-alone leg)",
    "compute_s": "compute (device step)",
    "stall_loss_fetch_s":
        "trainer.loss_fetch (trainer_stall_seconds{component=loss_fetch})",
    "stall_finite_check_s":
        "trainer.finite_check "
        "(trainer_stall_seconds{component=finite_check})",
    "stall_audit_fetch_s":
        "trainer.audit_fetch "
        "(trainer_stall_seconds{component=audit_fetch})",
    "stall_checkpoint_s": "checkpoint (ckpt_write_seconds)",
    "ckpt_write_mean_s": "checkpoint (ckpt_write_seconds)",
    "stall_comm_encode_s":
        "trainer.comm_encode (trainer_stall_seconds{component=comm_encode})",
    "stall_comm_allreduce_s":
        "trainer.comm_allreduce "
        "(trainer_stall_seconds{component=comm_allreduce})",
    "stall_comm_decode_s":
        "trainer.comm_decode (trainer_stall_seconds{component=comm_decode})",
}


def _attribute(entry: dict, ledger: pl.PerfLedger,
               now: float) -> dict | None:
    """Name the stage whose time grew the most (relative to its own
    baseline median) inside a regressed entry — advisory, so it uses
    whatever history exists instead of refusing on small samples."""
    fpk = pl.fp_key(entry.get("fp") or {})
    best = None
    for m, v in (entry.get("metrics") or {}).items():
        if m not in _STAGE_LABELS:
            continue
        hist = ledger.history(m, fpk, before_t=now)
        if hist:
            import statistics
            med = statistics.median(hist[-8:])
        else:
            med = 0.0
        grew = v - med
        if grew <= 0:
            continue
        rel = grew / max(abs(med), 1e-9)
        cand = {"stage": _STAGE_LABELS[m], "metric": m,
                "value_s": round(v, 4), "baseline_s": round(med, 4),
                "grew_s": round(grew, 4),
                "grew_rel": round(min(rel, 1e6), 2)}
        if best is None or cand["grew_rel"] > best["grew_rel"]:
            best = cand
    return best


def run_regress(capture_doc: dict, ledger: pl.PerfLedger, *,
                window: int = 8, k: float = 4.0, min_history: int = 3,
                min_band_frac: float = 0.0,
                device_hint: str | None = None) -> dict:
    """The sentinel core: entries from one fresh capture, each metric
    against its (metric, fingerprint) band.  Returns the verdict doc;
    ``ok`` is False iff any metric regressed.  A capture of another
    device never gates: the device is part of the fingerprint."""
    now = time.time()
    entries = pl.entries_from_any(capture_doc, None, t=now,
                                  device_hint=device_hint)
    results = []
    regressions = 0
    gated = 0
    for e in entries:
        fpk = pl.fp_key(e.get("fp") or {})
        for m, v in (e.get("metrics") or {}).items():
            if m in _STAGE_LABELS:
                continue   # stages attribute regressions; they don't gate
            base = ledger.baseline(m, fpk, window=window, k=k,
                                   min_history=min_history,
                                   min_band_frac=min_band_frac,
                                   before_t=now)
            vd = pl.verdict(m, v, base)
            row = {"metric": m, "fingerprint": fpk, "value": v,
                   "verdict": vd}
            if base.gated:
                gated += 1
                row["band"] = {"n": base.n,
                               "median": round(base.median, 4),
                               "lo": round(base.lo, 4),
                               "hi": round(base.hi, 4)}
            else:
                row["reason"] = base.reason or "no baseline"
            if vd == "regression":
                regressions += 1
                attr = _attribute(e, ledger, now)
                if attr:
                    row["attribution"] = attr
            results.append(row)
    return {"ok": regressions == 0,
            "regressions": regressions,
            "metrics_checked": len(results),
            "metrics_gated": gated,
            "window": window, "k": k, "min_history": min_history,
            "min_band_pct": round(min_band_frac * 100, 1),
            "results": results}


def _print_regress(doc: dict) -> None:
    for row in doc["results"]:
        tag = {"regression": "REGRESSION", "improvement": "improved",
               "within_band": "ok", "not_gated": "not gated"}[
                   row["verdict"]]
        line = f"  {tag:<11} {row['metric']:<24} {row['value']:g}"
        if "band" in row:
            b = row["band"]
            line += (f"  band [{b['lo']:g}, {b['hi']:g}] "
                     f"(median {b['median']:g}, n={b['n']})")
        else:
            line += f"  ({row['reason']})"
        print(line)
        attr = row.get("attribution")
        if attr:
            print(f"      -> attributed to {attr['stage']}: "
                  f"{attr['baseline_s']:g}s -> {attr['value_s']:g}s "
                  f"(+{attr['grew_rel']:g}x)")
    print(f"[perfwatch] regress: {doc['metrics_checked']} metric(s), "
          f"{doc['metrics_gated']} gated, "
          f"{doc['regressions']} regression(s)")


def cmd_regress(args) -> int:
    ledger = pl.PerfLedger(args.ledger)
    try:
        with open(args.capture) as f:
            text = f.read()
        # a bench stdout log may hold progress lines; the capture is the
        # last JSON line
        doc = None
        for line in reversed(text.strip().splitlines()):
            line = line.strip()
            if line.startswith("{"):
                try:
                    doc = json.loads(line)
                except json.JSONDecodeError:
                    pass   # pretty-printed JSON: an inner line matched
                break
        if doc is None:
            doc = json.loads(text)
    except (OSError, json.JSONDecodeError) as e:
        _log(f"cannot read capture {args.capture!r}: {e}")
        return 2
    out = run_regress(doc, ledger, window=args.window, k=args.k,
                      min_history=args.min_history,
                      min_band_frac=args.min_band_pct / 100.0,
                      device_hint=args.device_hint)
    _print_regress(out)
    if args.json:
        with open(args.json, "w") as f:
            json.dump(out, f, indent=1)
    if args.ingest and out["ok"]:
        _ingest_file(ledger, args.capture,
                     device_hint=args.device_hint, round_tag=args.round)
    return 0 if out["ok"] else 1


# ---------------------------------------------------------------------------
# diff — the op-profile differ + fusion-candidate worklist
# ---------------------------------------------------------------------------

def _load_op_table(path: str) -> tuple[dict, str]:
    p = path
    if os.path.isdir(p):
        p = os.path.join(p, "op_table.json")
    with open(p) as f:
        return json.load(f), os.path.relpath(p, REPO)


def _rows_by_op(rows) -> dict[str, dict]:
    return {r["op"]: r for r in rows or [] if r.get("op")}


def diff_profiles(a_doc: dict, b_doc: dict, *, top: int = 12) -> dict:
    """Join two op_table captures by op category (and by layer when both
    carry the per-layer view), then rank fusion candidates in B.

    A category present on only one side is reported as only_in_a /
    only_in_b with its full time as the delta — a category VANISHING
    (e.g. LRN custom-call after a fusion pass) is exactly the signal
    the differ exists to show.

    The fusion worklist (``graph/fusion.py::fusion_worklist``):
    by_layer chains that are bandwidth-bound (arithmetic-bound convs are
    excluded) and run below the capture's best fused-chain bandwidth;
    ``reclaimable_ms`` estimates what closing the bandwidth gap is worth
    (``total_ms · (1 − gb/ref)``), the ranking the ``auto`` plan
    reads."""
    a_sum, b_sum = a_doc.get("summary") or {}, b_doc.get("summary") or {}
    a_cat, b_cat = (_rows_by_op(a_doc.get("by_category")),
                    _rows_by_op(b_doc.get("by_category")))
    cats = []
    for op in sorted(set(a_cat) | set(b_cat)):
        ra, rb = a_cat.get(op), b_cat.get(op)
        row = {"op": op,
               "status": ("both" if ra and rb
                          else "only_in_a" if ra else "only_in_b"),
               "a_ms": ra["total_ms"] if ra else None,
               "b_ms": rb["total_ms"] if rb else None,
               "a_gb_s": ra.get("gb_per_s") if ra else None,
               "b_gb_s": rb.get("gb_per_s") if rb else None}
        row["delta_ms"] = round((row["b_ms"] or 0.0)
                                - (row["a_ms"] or 0.0), 3)
        if row["a_gb_s"] and row["b_gb_s"]:
            row["delta_gb_s"] = round(row["b_gb_s"] - row["a_gb_s"], 1)
        cats.append(row)
    cats.sort(key=lambda r: -abs(r["delta_ms"]))

    layers = []
    a_lay, b_lay = (_rows_by_op(a_doc.get("by_layer")),
                    _rows_by_op(b_doc.get("by_layer")))
    for op in sorted(set(a_lay) | set(b_lay)):
        ra, rb = a_lay.get(op), b_lay.get(op)
        layers.append({
            "layer": op,
            "status": ("both" if ra and rb
                       else "only_in_a" if ra else "only_in_b"),
            "a_ms": ra["total_ms"] if ra else None,
            "b_ms": rb["total_ms"] if rb else None,
            "delta_ms": round((rb["total_ms"] if rb else 0.0)
                              - (ra["total_ms"] if ra else 0.0), 3)})
    layers.sort(key=lambda r: -abs(r["delta_ms"]))

    worklist = fusion_worklist(b_doc, top=top)
    return {"a": a_sum, "b": b_sum,
            "a_total_ms": a_doc.get("total_ms"),
            "b_total_ms": b_doc.get("total_ms"),
            "step_delta_ms": round((b_sum.get("step_ms") or 0.0)
                                   - (a_sum.get("step_ms") or 0.0), 2)
            if a_sum.get("step_ms") and b_sum.get("step_ms") else None,
            "categories": cats, "layers": layers,
            "fusion_worklist": worklist}


def cmd_diff(args) -> int:
    try:
        a_doc, a_path = _load_op_table(args.a)
        b_doc, b_path = _load_op_table(args.b)
    except (OSError, json.JSONDecodeError) as e:
        _log(f"cannot load profiles: {e}")
        return 2
    out = diff_profiles(a_doc, b_doc, top=args.top)
    a_sum, b_sum = out["a"], out["b"]
    print(f"perf diff: A={a_path} ({a_sum.get('model')} "
          f"{a_sum.get('dtype')} b{a_sum.get('batch')}, step "
          f"{a_sum.get('step_ms')} ms)")
    print(f"           B={b_path} ({b_sum.get('model')} "
          f"{b_sum.get('dtype')} b{b_sum.get('batch')}, step "
          f"{b_sum.get('step_ms')} ms)")
    if out["step_delta_ms"] is not None:
        print(f"  step delta: {out['step_delta_ms']:+.2f} ms")
    print("  by category (trace-total ms; sorted by |delta|):")
    for r in out["categories"][:args.top]:
        a_ms = "-" if r["a_ms"] is None else f"{r['a_ms']:.2f}"
        b_ms = "-" if r["b_ms"] is None else f"{r['b_ms']:.2f}"
        gb = ""
        if "delta_gb_s" in r:
            gb = f"  {r['a_gb_s']:.0f}->{r['b_gb_s']:.0f} GB/s"
        note = "" if r["status"] == "both" else f"  [{r['status']}]"
        print(f"    {r['op']:<26} {a_ms:>9} -> {b_ms:>9} ms "
              f"({r['delta_ms']:+.2f}){gb}{note}")
    moved = [r for r in out["layers"] if r["status"] != "both"]
    if moved:
        # a layer row vanishing while an a+b+c row appears IS the
        # fusion pass's signature (each chain becomes one L[...] scope)
        print("  layer rows present on one side only:")
        for r in moved[:args.top]:
            ms = r["a_ms"] if r["a_ms"] is not None else r["b_ms"]
            print(f"    {r['layer']:<44} {ms:>9.2f} ms [{r['status']}]")
    wl = out["fusion_worklist"]
    if wl.get("candidates"):
        print(f"  fusion-candidate worklist for B "
              f"(ref {wl['ref_gb_per_s']} GB/s, "
              f"{wl['reclaimable_ms_total']} ms reclaimable):")
        for i, c in enumerate(wl["candidates"], 1):
            print(f"    #{i} {c['chain']:<22} {c['kind']:<22} "
                  f"{c['total_ms']:>8.2f} ms @ {c['gb_per_s']:>7.1f} GB/s"
                  f" -> reclaim {c['reclaimable_ms']:>6.2f} ms")
            if c.get("note"):
                print(f"        {c['note']}")
    elif wl.get("note"):
        print(f"  {wl['note']}")
    else:
        print("  fusion-candidate worklist for B: empty — no unfused "
              "chain runs below the capture's fused-chain band")
    for c in wl.get("fused_chains") or []:
        verdict = ("at ref band" if c["at_ref_band"]
                   else "BELOW ref band")
        print(f"    fused {c['chain']:<34} {c['total_ms']:>8.2f} ms @ "
              f"{c['gb_per_s']:>7.1f} GB/s ({verdict}, "
              f"ref {c['ref_gb_per_s']})")
    if args.json:
        with open(args.json, "w") as f:
            json.dump(out, f, indent=1)
        _log(f"wrote {args.json}")
    return 0


# ---------------------------------------------------------------------------
# trajectory
# ---------------------------------------------------------------------------

_TRAJ_BEGIN = "<!-- perfwatch:trajectory:begin -->"
_TRAJ_END = "<!-- perfwatch:trajectory:end -->"

_HEADLINE = ("train_img_s", "mfu", "eval_img_s")


def build_trajectory(ledger: pl.PerfLedger) -> dict:
    """One row per round tag: the round's best train capture plus its
    feed and serving numbers, r01 → now."""
    rounds: dict[str, dict] = {}
    for e in ledger.entries():
        tag = e.get("round")
        if not tag:
            continue
        row = rounds.setdefault(tag, {"round": tag})
        m = e.get("metrics") or {}
        fp = e.get("fp") or {}
        src = e.get("source")
        if src == "bench" and m.get("train_img_s"):
            if m["train_img_s"] > (row.get("train_img_s") or 0.0):
                row.update(
                    train_img_s=m.get("train_img_s"), mfu=m.get("mfu"),
                    eval_img_s=m.get("eval_img_s"),
                    model=fp.get("model"), dtype=fp.get("dtype"),
                    batch=fp.get("batch"), device=fp.get("device"),
                    sha=e.get("sha"))
        elif src == "bench_feed" and m.get("feed_img_s") is not None:
            row["feed_img_s"] = m.get("feed_img_s")
        elif src == "bench_round":
            row["round_stall_async_s"] = m.get("round_stall_async_s")
        elif src == "serving":
            row.update(serve_sat_qps=m.get("serve_sat_qps"),
                       serve_speedup_x=m.get("serve_speedup_x"),
                       serve_overload_p99_ms=m.get(
                           "serve_overload_p99_ms"))
            row.setdefault("sha", e.get("sha"))
            row.setdefault("device", fp.get("device"))
        elif src == "serving_fleet":
            row.update(fleet_sat_qps=m.get("serve_fleet_sat_qps"),
                       fleet_replicas=fp.get("replicas"))
            row.setdefault("sha", e.get("sha"))
            row.setdefault("device", fp.get("device"))
    ordered = [rounds[t] for t in sorted(rounds, key=pl._round_sort_key)]
    return {"generated_at": time.strftime("%Y-%m-%dT%H:%M:%S%z"),
            "git_sha": pl.git_sha(),
            "ledger": ledger.path,
            "entries": len(ledger.entries()),
            "fingerprints": len(ledger.fingerprints()),
            "rounds": ordered}


def _fmt(v, spec="{:g}") -> str:
    return "—" if v is None else spec.format(v)


def render_trajectory_md(traj: dict) -> str:
    lines = [
        _TRAJ_BEGIN,
        "## Perf trajectory (rendered by `perfwatch trajectory`)",
        "",
        f"From `{traj['ledger']}` ({traj['entries']} entries, "
        f"{traj['fingerprints']} fingerprints) at "
        f"`{traj.get('git_sha') or 'unknown'}` — regenerate with "
        "`python -m sparknet_tpu_torch.tools.perfwatch trajectory`; do "
        "not edit by hand.",
        "",
        "| round | sha | device | config | train img/s | MFU | "
        "eval img/s | feed img/s | serve qps (sat) | overload p99 ms | "
        "fleet qps (N) |",
        "|---|---|---|---|---|---|---|---|---|---|---|",
    ]
    for r in traj["rounds"]:
        cfg = "—"
        if r.get("model"):
            cfg = f"{r['model']}/{r.get('dtype')}/b{r.get('batch')}"
        fleet = "—"
        if r.get("fleet_sat_qps") is not None:
            fleet = (f"{r['fleet_sat_qps']:g} "
                     f"(x{r.get('fleet_replicas')})")
        lines.append(
            "| {} | {} | {} | {} | {} | {} | {} | {} | {} | {} | {} |"
            .format(
                r["round"], r.get("sha") or "—", r.get("device") or "—",
                cfg, _fmt(r.get("train_img_s")), _fmt(r.get("mfu")),
                _fmt(r.get("eval_img_s")), _fmt(r.get("feed_img_s")),
                _fmt(r.get("serve_sat_qps")),
                _fmt(r.get("serve_overload_p99_ms")), fleet))
    lines += ["", _TRAJ_END]
    return "\n".join(lines)


def splice_markers(text: str, block: str) -> str:
    """Replace the marker-delimited block in ``text`` (or insert one
    before the first ``## `` heading when absent) — idempotent."""
    if _TRAJ_BEGIN in text and _TRAJ_END in text:
        head, rest = text.split(_TRAJ_BEGIN, 1)
        _, tail = rest.split(_TRAJ_END, 1)
        return head + block + tail
    idx = text.find("\n## ")
    if idx < 0:
        sep = "" if text.endswith("\n") else "\n"
        return text + sep + "\n" + block + "\n"
    return text[:idx + 1] + block + "\n\n" + text[idx + 1:]


def cmd_trajectory(args) -> int:
    ledger = pl.PerfLedger(args.ledger)
    if not ledger.entries():
        _log(f"ledger {ledger.path} is empty — run "
             f"`perfwatch ingest` first")
        return 2
    traj = build_trajectory(ledger)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(traj, f, indent=1)
    _log(f"wrote {args.out} ({len(traj['rounds'])} rounds)")
    block = render_trajectory_md(traj)
    if args.md:
        try:
            with open(args.md) as f:
                text = f.read()
        except OSError:
            text = "# Perf trajectory\n"
        with open(args.md, "w") as f:
            f.write(splice_markers(text, block))
        _log(f"updated {args.md} between perfwatch markers")
    else:
        print(block)
    return 0


# ---------------------------------------------------------------------------
# perfgate — the perf regression gate (the JAX run_tier1.sh gate of that name)
# ---------------------------------------------------------------------------

_SMOKE_ENV = {
    "BENCH_MODEL": "lenet", "BENCH_BATCH": "8", "BENCH_ITERS": "2",
    "BENCH_REPS": "2", "BENCH_WINDOWS": "1", "BENCH_DTYPE": "f32",
    "BENCH_FEED_BATCH": "8", "BENCH_FEED_ITERS": "4", "BENCH_ROUND": "0",
    "BENCH_SERVING": "0", "BENCH_FEED_RECORDS": "0",
    "BENCH_TIMEOUT_S": "240",
}


def _run_bench_smoke(device: str,
                     extra_env: dict | None = None) -> dict | None:
    env = {k: v for k, v in os.environ.items()
           if not k.startswith("BENCH_")}
    env.update(_SMOKE_ENV)
    if extra_env:
        env.update(extra_env)
    t0 = time.monotonic()
    p = subprocess.run([sys.executable, "-m", "sparknet_tpu_torch.bench",
                        "--device", device], env=env, cwd=REPO,
                       stdout=subprocess.PIPE, stderr=subprocess.DEVNULL,
                       timeout=420)
    lines = p.stdout.decode().strip().splitlines()
    _log(f"bench smoke rc={p.returncode} in "
         f"{time.monotonic() - t0:.1f}s")
    if p.returncode != 0 or not lines:
        return None
    try:
        return json.loads(lines[-1])
    except json.JSONDecodeError:
        return None


def cmd_perfgate(args) -> int:
    """Two legs.  (1) A fresh bench smoke on ``--device`` must not
    regress against the ledger (fingerprints without history are not
    gated).  (2) The sentinel self-test: the same smoke with a slowed
    feed leg (BENCH_FEED_DELAY_S) regressed against a scratch ledger
    seeded from the fresh capture must exit non-zero and attribute the
    breach to the decode stage — a gate that cannot catch a planted
    regression is not a gate."""
    import tempfile
    verdict: dict = {"ok": False}
    failures: list[str] = []

    fresh = _run_bench_smoke(args.device)
    if fresh is None:
        _log("perfgate: bench smoke failed to produce a capture")
        return 1
    ledger = pl.PerfLedger(args.ledger)
    reg = run_regress(fresh, ledger, min_band_frac=args.min_band_pct / 100)
    _print_regress(reg)
    verdict["fresh"] = {k: reg[k] for k in
                       ("ok", "regressions", "metrics_checked",
                        "metrics_gated")}
    if not reg["ok"]:
        failures.append(f"fresh smoke regressed "
                        f"{reg['regressions']} metric(s) vs the ledger")

    # sentinel self-test: seed a scratch ledger from the fresh capture
    # (3 copies = just past the small-sample refusal), slow the feed
    # leg, and demand the sentinel catches it with the right stage name
    with tempfile.TemporaryDirectory() as tmp:
        scratch = pl.PerfLedger(os.path.join(tmp, "LEDGER.jsonl"))
        base_t = time.time() - 3600
        for i in range(3):
            for e in pl.entries_from_any(fresh, "perfgate_seed",
                                         t=base_t + i):
                scratch.append(e)
        slowed = _run_bench_smoke(args.device,
                                  {"BENCH_FEED_DELAY_S": "0.05"})
        if slowed is None:
            failures.append("slowed bench smoke failed to run")
        else:
            reg2 = run_regress(slowed, scratch,
                               min_band_frac=args.min_band_pct / 100)
            _print_regress(reg2)
            feed_rows = [r for r in reg2["results"]
                         if r["metric"] == "feed_img_s"]
            tripped = [r for r in feed_rows
                       if r["verdict"] == "regression"]
            verdict["sentinel"] = {
                "tripped": bool(tripped),
                "attribution": (tripped[0].get("attribution")
                                if tripped else None)}
            if not tripped:
                failures.append("sentinel self-test: injected slow feed "
                                "leg did NOT register as a regression")
            else:
                attr = tripped[0].get("attribution") or {}
                if "decode" not in (attr.get("metric") or ""):
                    failures.append(
                        f"sentinel self-test: regression attributed to "
                        f"{attr.get('stage')!r}, expected the decode "
                        f"stage")

    verdict["failures"] = failures
    verdict["ok"] = not failures
    if args.json:
        with open(args.json, "w") as f:
            json.dump(verdict, f, indent=1)
    if failures:
        _log("PERFGATE FAILED: " + "; ".join(failures))
        return 1
    _log("perfgate OK: fresh smoke within/not-gated, sentinel catches a "
         "planted feed regression with decode attribution")
    return 0


# ---------------------------------------------------------------------------
# main
# ---------------------------------------------------------------------------

def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="performance observatory")
    sub = ap.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("ingest", help="append captures to the ledger")
    p.add_argument("files", nargs="*", help="capture files to ingest")
    p.add_argument("--backfill", action="store_true",
                   help="walk the port's committed profiles")
    p.add_argument("--ledger", required=True)
    p.add_argument("--round", default=None, help="round tag, e.g. r09")
    p.add_argument("--device-hint", default=None,
                   help="device for artifacts that predate stamping")

    p = sub.add_parser("regress", help="gate a fresh capture against "
                                       "its baseline bands")
    p.add_argument("--capture", required=True)
    p.add_argument("--ledger", required=True)
    p.add_argument("--window", type=int, default=8)
    p.add_argument("--k", type=float, default=4.0)
    p.add_argument("--min-history", type=int, default=3)
    p.add_argument("--min-band-pct", type=float, default=0.0,
                   help="floor on band half-width as %% of the median "
                        "(the wide-CPU-bands knob)")
    p.add_argument("--device-hint", default=None)
    p.add_argument("--json", default=None)
    p.add_argument("--round", default=None)
    p.add_argument("--ingest", action="store_true",
                   help="append the capture to the ledger when it "
                        "passes")

    p = sub.add_parser("diff", help="op-profile differ + fusion "
                                    "worklist")
    p.add_argument("a", help="profile dir or op_table.json (before)")
    p.add_argument("b", help="profile dir or op_table.json (after)")
    p.add_argument("--top", type=int, default=12)
    p.add_argument("--json", default=None,
                   help="write the full diff + worklist JSON here")

    p = sub.add_parser("trajectory", help="render the per-round table")
    p.add_argument("--ledger", required=True)
    p.add_argument("--out", required=True, help="trajectory JSON path")
    p.add_argument("--md", default=None,
                   help="markdown file to splice the table into "
                        "(default: print it)")

    p = sub.add_parser("perfgate", help="bench smoke + sentinel self-test")
    p.add_argument("--ledger", required=True)
    p.add_argument("--device", default="cuda")
    p.add_argument("--min-band-pct", type=float, default=10.0)
    p.add_argument("--json", default=None)

    args = ap.parse_args(argv)
    return {"ingest": cmd_ingest, "regress": cmd_regress,
            "diff": cmd_diff, "trajectory": cmd_trajectory,
            "perfgate": cmd_perfgate}[args.cmd](args)


if __name__ == "__main__":
    sys.exit(main())
