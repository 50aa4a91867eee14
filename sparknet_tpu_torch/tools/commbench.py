"""Comm-codec parity gate: the compressed exchange's five verdicts.

The port's own copy of the root ``tools/commbench.py``, with the port's
``--device`` (cuda unless the caller asks for the CPU).  The mesh of the
JAX tool is ``--devices`` logical workers of one ``DistributedTrainer`` on
the device; the batches are drawn with numpy from the JAX tool's seeds
(``4200 + r``).  Five verdicts on lenet, any failure = rc 1:

1. **codec-none bit-identity**: a trainer with ``comm_codec="none"``
   (overlap on or off) gives bit-identical losses and params to one built
   without a codec.
2. **error-feedback invariant**: for every real codec,
   ``decode(encode(delta)) + residual == delta`` exactly in f32.  A
   planted codec that drops its residual (``keep_residual=False``) must
   fail it, so the gate is shown able to catch what it exists for.
3. **loss band**: int8, int8_channel and bf16 with error feedback land
   within ``LOSS_BAND`` of the full-precision trainer's final loss.
4. **overlap parity and stall**: ``comm_overlap=True`` is bit-identical to
   False under int8, with strictly less steady-state comm stall (after a
   warm-up round), and above 0.  On the card a lenet round leaves the
   device idle (the host's launches take longer than the kernels), so
   the waits overlap leaves out would be a few microseconds against
   milliseconds of launch noise; a spin of ``DEVICE_BACKLOG_MS`` queued
   ahead of each measured round keeps the device behind the host, as a
   real model's steps do, and makes those waits show (the same spin in
   both settings; ``device_backlog_ms``).  On the CPU every op finishes
   before it returns, so the two settings run the same host code and
   their stalls differ by noise alone: there the comparison is reported,
   not gated (``stall_gated``).
5. **wire bytes**: int8's exchanged bytes a round are at least 3x smaller
   than full precision's (``comms.exchange_bytes`` over the real encode).

Every training runs under deterministic cuDNN (the bit-identity verdicts
compare separate trainers) and with the garbage collector held off.

Usage:
    python -m sparknet_tpu_torch.tools.commbench [--rounds 8] \\
        [--devices 4] [--device cpu] [--out FILE]

Prints one JSON line on stdout (``"commbench": true`` is the ledger's
sniff key, ``utils/perfledger.entries_from_commbench``); rc 0 = all gates
hold.
"""

from __future__ import annotations

import argparse
import gc
import json
import sys
import time

LOSS_BAND = 0.05   # |final_loss_codec - final_loss_none| tolerance
DEVICE_BACKLOG_MS = 50.0   # a round's host launches take ~10-15 ms
REAL_CODECS = ("bf16", "int8", "int8_channel")
COMM_PARTS = ("comm_encode", "comm_allreduce", "comm_decode")


def main(argv=None) -> int:
    from ..utils.device import deterministic_cudnn
    # the bit-identity verdicts compare separate trainers' bits
    with deterministic_cudnn():
        return _gates(argv)


def _gates(argv) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--rounds", type=int, default=8)
    ap.add_argument("--devices", type=int, default=4,
                    help="workers of the round, sharing the device")
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--tau", type=int, default=2)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    from ..models import lenet
    from ..parallel import DistributedTrainer, TrainerConfig, comms
    from ..proto import load_solver_prototxt_with_net
    from ..utils.device import device_label, resolve_device

    dev = resolve_device(args.device)
    tau = args.tau
    sp = load_solver_prototxt_with_net(
        'base_lr: 0.005\nmomentum: 0.9\nlr_policy: "fixed"\n',
        lenet(args.batch, args.batch))

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    backlog_cycles = 0
    if dev.type == "cuda":
        # the spin's cycles a millisecond on this card, timed once
        start, end = (torch.cuda.Event(enable_timing=True)
                      for _ in range(2))
        torch.cuda._sleep(1000)
        start.record()
        torch.cuda._sleep(10_000_000)
        end.record()
        end.synchronize()
        backlog_cycles = int(DEVICE_BACKLOG_MS * 10_000_000
                             / start.elapsed_time(end))

    def batch(r):
        rng = np.random.default_rng(4200 + r)
        return {"data": rng.normal(size=(tau, args.batch, 1, 28, 28)
                                   ).astype(np.float32),
                "label": rng.integers(0, 10, size=(tau, args.batch)
                                      ).astype(np.float32)}

    def run(cfg: TrainerConfig, measure_stall: bool = False) -> dict:
        tr = DistributedTrainer(sp, args.devices, cfg, seed=0, device=dev)
        # no collection inside a training: its pause would be charged to
        # whichever stage allocates when it starts (a long-lived caller's
        # heap made one 50% of a run's comm stall on the card)
        gc.collect()
        collecting = gc.isenabled()
        gc.disable()
        try:
            t0 = time.perf_counter()
            warm = 1 if measure_stall else 0
            losses = []
            for r in range(args.rounds):
                # on the device before the spin: an upload inside the
                # round would wait the spin out there
                b = {k: torch.from_numpy(v).to(dev)
                     for k, v in batch(r).items()}
                if measure_stall and r >= warm and backlog_cycles:
                    torch.cuda._sleep(backlog_cycles)
                loss = tr.train_round(b)
                if r + 1 == warm:
                    # the first round's allocations and kernel loads
                    # settled: zero the comm components so the stall is
                    # steady-state
                    sync()
                    for k in COMM_PARTS:
                        tr.stall_s[k] = 0.0
                    t0 = time.perf_counter()
                losses.append(loss)
            tr.drain()
            sync()
            dt = time.perf_counter() - t0
        finally:
            if collecting:
                gc.enable()
        return {
            "losses": losses,
            "params": {k: [b.detach().cpu().numpy() for b in v]
                       for k, v in tr.params.items()},
            "wall_s": round(dt, 3),
            "stall_s": {k: round(v, 4) for k, v in tr.stall_s.items()},
            "comm_stall_s": round(sum(
                v for k, v in tr.stall_s.items()
                if k.startswith("comm_")), 4),
        }

    def bit_identical(a: dict, b: dict) -> list[str]:
        out = []
        if a["losses"] != b["losses"]:
            out.append(f"losses diverge: {a['losses']} vs {b['losses']}")
        for name, blobs in a["params"].items():
            for i, x in enumerate(blobs):
                if not np.array_equal(x, b["params"][name][i]):
                    out.append(f"param {name}[{i}] not bit-identical")
        return out

    failures: list[str] = []

    # -- 1. codec none == the codec-less trainer, overlap inert -----------
    base = run(TrainerConfig(strategy="local_sgd", tau=tau))
    none_off = run(TrainerConfig(strategy="local_sgd", tau=tau,
                                 comm_codec="none", comm_overlap=False))
    none_on = run(TrainerConfig(strategy="local_sgd", tau=tau,
                                comm_codec="none", comm_overlap=True))
    failures += [f"[none-vs-base] {m}" for m in bit_identical(base, none_off)]
    failures += [f"[none-overlap] {m}" for m in bit_identical(base, none_on)]

    # -- 2. error-feedback invariant; the planted residual-dropper FAILS --
    int8 = comms.get_codec("int8")
    dropres = comms.Codec("int8_dropres", encode=int8.encode,
                          decode=int8.decode, keep_residual=False)
    rng = np.random.default_rng(7)
    delta = {
        "conv": [torch.as_tensor(rng.normal(scale=1e-3, size=(4, 8, 1, 5, 5)),
                                 dtype=torch.float32, device=dev)],
        "bias": [torch.as_tensor(rng.normal(scale=1e-4, size=(4, 8)),
                                 dtype=torch.float32, device=dev)],
    }

    def ef_invariant_holds(codec) -> bool:
        _, decoded, residual = comms.roundtrip_tree(codec, delta)
        return all(torch.equal(d + r, x)
                   for k in delta
                   for d, r, x in zip(decoded[k], residual[k], delta[k]))

    ef = {name: ef_invariant_holds(comms.get_codec(name))
          for name in REAL_CODECS}
    ef["int8_dropres"] = ef_invariant_holds(dropres)
    for name in REAL_CODECS:
        if not ef[name]:
            failures.append(f"[ef] codec {name} violates the "
                            f"error-feedback invariant")
    if ef["int8_dropres"]:
        failures.append("[ef] planted residual-dropping codec PASSED the "
                        "invariant gate — the gate is broken, not the codec")

    # -- 3 + 4. lossy codecs: loss band, overlap parity, stall ------------
    codec_runs: dict[str, dict] = {}
    for name in REAL_CODECS:
        r = run(TrainerConfig(strategy="local_sgd", tau=tau,
                              comm_codec=name), measure_stall=True)
        codec_runs[name] = r
        drift = abs(r["losses"][-1] - base["losses"][-1])
        if not np.isfinite(r["losses"][-1]) or drift > LOSS_BAND:
            failures.append(
                f"[band] codec {name} final loss {r['losses'][-1]:.4f} "
                f"vs none {base['losses'][-1]:.4f} (|Δ|={drift:.4f} > "
                f"{LOSS_BAND})")
    int8_overlap = run(TrainerConfig(strategy="local_sgd", tau=tau,
                                     comm_codec="int8", comm_overlap=True),
                       measure_stall=True)
    failures += [f"[overlap-int8] {m}"
                 for m in bit_identical(codec_runs["int8"], int8_overlap)]
    stall_sync = codec_runs["int8"]["comm_stall_s"]
    stall_overlap = int8_overlap["comm_stall_s"]
    stall_gated = dev.type == "cuda"
    if not sum(int8_overlap["stall_s"][k] for k in COMM_PARTS) > 0:
        failures.append(f"[stall] no comm stall charged under overlap: "
                        f"{int8_overlap['stall_s']}")
    if stall_gated and not stall_overlap < stall_sync:
        failures.append(
            f"[stall] overlap did not reduce comm stall: "
            f"{stall_overlap}s overlapped vs {stall_sync}s synchronous")

    # -- 5. wire bytes ----------------------------------------------------
    tr_probe = DistributedTrainer(
        sp, args.devices, TrainerConfig(strategy="local_sgd", tau=tau),
        seed=0, device=dev)
    n_tier = args.devices
    bytes_none = comms.exchange_bytes(comms.get_codec("none"),
                                      tr_probe.params, n_tier)
    bytes_by_codec = {
        name: comms.exchange_bytes(comms.get_codec(name), tr_probe.params,
                                   n_tier)
        for name in REAL_CODECS}
    shrink = round(bytes_none / bytes_by_codec["int8"], 3)
    if shrink < 3.0:
        failures.append(f"[bytes] int8 shrink {shrink}x < 3x")

    result = {
        "commbench": True,   # ingest sniff key (perfledger.entries_from_any)
        "ok": not failures,
        "failures": failures,
        "rounds": args.rounds,
        "tau": tau,
        "batch": args.batch,
        "devices": args.devices,
        "device": device_label(dev),
        "ef_invariant": ef,
        "final_loss_none": base["losses"][-1],
        "none": {k: base[k] for k in ("wall_s", "stall_s")},
        "codecs": {
            name: {"wall_s": r["wall_s"], "stall_s": r["stall_s"],
                   "comm_stall_s": r["comm_stall_s"],
                   "final_loss": r["losses"][-1],
                   "exchange_bytes": bytes_by_codec[name]}
            for name, r in codec_runs.items()},
        "overlap_int8": {"wall_s": int8_overlap["wall_s"],
                         "stall_s": int8_overlap["stall_s"],
                         "comm_stall_s": stall_overlap},
        "exchange_bytes_none": bytes_none,
        "comm_stall_sync_s": stall_sync,
        "comm_stall_overlap_s": stall_overlap,
        "stall_gated": stall_gated,
        "device_backlog_ms": DEVICE_BACKLOG_MS if backlog_cycles else 0.0,
        "comm_bytes_shrink_x": shrink,
    }
    line = json.dumps(result)
    print(line, flush=True)
    if args.out:
        with open(args.out, "w") as f:
            f.write(line + "\n")
    if failures:
        print(f"[commbench] GATE FAILURE: {failures}", file=sys.stderr,
              flush=True)
        return 1
    print(f"[commbench] all gates hold: codec none bit-identical, EF "
          f"invariant green (planted dropper caught), int8 shrink "
          f"{shrink}x, comm stall {stall_sync}s sync -> {stall_overlap}s "
          f"overlapped", file=sys.stderr, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
