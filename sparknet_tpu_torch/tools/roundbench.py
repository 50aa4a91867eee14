"""Synchronous against asynchronous outer loop: the round parity gate.

    python -m sparknet_tpu_torch.tools.roundbench [--rounds 6] [--lag 2]
        [--devices 4] [--batch 16] [--out FILE] [--device cuda|cpu]

The port's copy of the root ``tools/roundbench.py``, with the port's
``--device`` (the card unless the caller asks for the CPU).  The
zero-stall outer loop (``TrainerConfig.harvest_lag`` round pipelining
and the asynchronous checkpoint writer) must be a pure latency
optimisation: with round checkpoints and the numerics guard on, the
asynchronous loop gives the same round losses, bit-identical final
parameters and a bit-identical newest checkpoint as the synchronous
loop.  Both loops run ``--devices`` LeNet workers (``local_sgd``, τ=2)
on one device; the run fails on any divergence and reports each loop's
host stall seconds by component (``DistributedTrainer.stall_s``).

The JAX tool also runs the cross-replica audit (``audit_every=1``),
which the port refuses (ROADMAP A12): the loops run without it,
``audit_fetch`` is ``null`` and the line carries ``"not_ported_legs":
{"audit": "ROADMAP A12"}``.  The checkpoint fields compared are the JAX
tool's, with the port's generator states (``torch_generators``) in the
place of the JAX package's ``rng`` key.

Prints one JSON line on stdout (the JAX line's keys and
``not_ported_legs``); exit 0 when parity holds.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

import numpy as np

TAU = 2
# the newest checkpoint's fields held bit for bit: the JAX tool's, the
# port's generator states in the place of its ``rng``
CKPT_FIELDS = ("params", "state", "iter", "round", "torch_generators")
NOT_PORTED = {"audit": "ROADMAP A12"}


def _leaves(tree) -> list[np.ndarray]:
    """Every leaf of a loaded checkpoint tree, dict keys in sorted order."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    return [np.asarray(tree)]


def _batch(r: int, batch: int) -> dict:
    rng = np.random.default_rng(4200 + r)
    return {"data": rng.normal(size=(TAU, batch, 1, 28, 28)
                               ).astype(np.float32),
            "label": rng.integers(0, 10, size=(TAU, batch)
                                  ).astype(np.float32)}


def run_loop(mode: str, ckdir: str, *, rounds: int, lag: int, workers: int,
             batch: int, device) -> dict:
    """One outer loop, ``sync`` or ``async``: its losses, final params,
    newest checkpoint, wall seconds and stalls."""
    from ..models import lenet
    from ..parallel.trainer import DistributedTrainer, TrainerConfig
    from ..proto import load_solver_prototxt_with_net
    from ..utils import knobs
    from ..utils.checkpoint import load_checkpoint

    sp = load_solver_prototxt_with_net(
        'base_lr: 0.005\nmomentum: 0.9\nlr_policy: "fixed"\n',
        lenet(batch, batch))
    saved = knobs.raw("SPARKNET_ASYNC_CKPT")
    os.environ["SPARKNET_ASYNC_CKPT"] = "1" if mode == "async" else "0"
    try:
        cfg = TrainerConfig(
            strategy="local_sgd", tau=TAU, checkpoint_dir=ckdir,
            checkpoint_keep=4, guard_numerics=True,
            harvest_lag=lag if mode == "async" else 0)
        tr = DistributedTrainer(sp, workers, cfg, seed=0, device=device)
        t0 = time.perf_counter()
        while tr.round < rounds:
            tr.train_round(_batch(tr.round, batch))
        losses = tr.drain()
        dt = time.perf_counter() - t0
    finally:
        if saved is None:
            os.environ.pop("SPARKNET_ASYNC_CKPT", None)
        else:
            os.environ["SPARKNET_ASYNC_CKPT"] = saved
    newest = sorted(f for f in os.listdir(ckdir) if f.endswith(".npz"))[-1]
    stalls = {k: round(v, 4) for k, v in tr.stall_s.items()}
    stalls["audit_fetch"] = None     # the audit is ROADMAP A12
    return {
        "losses": [losses[r] for r in range(rounds)],
        "params": {k: [b.detach().cpu().numpy() for b in v]
                   for k, v in tr.params.items()},
        "newest_ckpt": newest,
        "ckpt_blob": load_checkpoint(os.path.join(ckdir, newest)),
        "wall_s": round(dt, 3),
        "stall_s": stalls,
    }


def parity_failures(sync: dict, async_: dict) -> list[str]:
    """Where the asynchronous loop differs from the synchronous one."""
    failures = []
    if sync["losses"] != async_["losses"]:
        failures.append(f"round losses diverge: sync {sync['losses']} "
                        f"vs async {async_['losses']}")
    for name, blobs in sync["params"].items():
        for i, b in enumerate(blobs):
            if not np.array_equal(b, async_["params"][name][i]):
                failures.append(f"param {name}[{i}] not bit-identical")
    if sync["newest_ckpt"] != async_["newest_ckpt"]:
        failures.append(f"newest checkpoint differs: "
                        f"{sync['newest_ckpt']} vs {async_['newest_ckpt']}")
        return failures
    for key in CKPT_FIELDS:
        if key not in sync["ckpt_blob"] or key not in async_["ckpt_blob"]:
            failures.append(f"checkpoint field {key!r} missing (sync "
                            f"{key in sync['ckpt_blob']}, async "
                            f"{key in async_['ckpt_blob']})")
            continue
        a = _leaves(sync["ckpt_blob"][key])
        b = _leaves(async_["ckpt_blob"][key])
        if len(a) != len(b) or any(
                not np.array_equal(x, y) for x, y in zip(a, b)):
            failures.append(f"checkpoint field {key!r} not bit-identical")
    return failures


def run(rounds: int = 6, lag: int = 2, devices: int = 4, batch: int = 16,
        device: str = "cuda") -> dict:
    """Both loops and the verdict: the line :func:`main` prints."""
    from ..utils.device import deterministic_cudnn, resolve_device
    dev = resolve_device(device)
    kw = dict(rounds=rounds, lag=lag, workers=devices, batch=batch,
              device=dev)
    with tempfile.TemporaryDirectory() as d_sync, \
            tempfile.TemporaryDirectory() as d_async, \
            deterministic_cudnn():
        sync = run_loop("sync", d_sync, **kw)
        async_ = run_loop("async", d_async, **kw)
    failures = parity_failures(sync, async_)

    def total(stalls: dict) -> float:
        return round(sum(v for v in stalls.values() if v is not None), 4)

    return {
        "ok": not failures,
        "failures": failures,
        "rounds": rounds,
        "harvest_lag": lag,
        "devices": devices,
        "sync": {k: sync[k] for k in ("wall_s", "stall_s", "losses")},
        "async": {k: async_[k] for k in ("wall_s", "stall_s")},
        "stall_total_sync_s": total(sync["stall_s"]),
        "stall_total_async_s": total(async_["stall_s"]),
        "not_ported_legs": dict(NOT_PORTED),
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rounds", type=int, default=6)
    ap.add_argument("--lag", type=int, default=2,
                    help="harvest_lag / pipeline depth of the async loop")
    ap.add_argument("--devices", type=int, default=4,
                    help="workers of each loop (all on the one device)")
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--out", default=None)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    result = run(args.rounds, args.lag, args.devices, args.batch,
                 args.device)
    line = json.dumps(result)
    print(line, flush=True)
    if args.out:
        with open(args.out, "w") as f:
            f.write(line + "\n")
    if result["failures"]:
        print(f"[roundbench] PARITY FAILURE: {result['failures']}",
              file=sys.stderr, flush=True)
        return 1
    print(f"[roundbench] parity holds over {args.rounds} rounds; host "
          f"stall {result['stall_total_sync_s']}s sync -> "
          f"{result['stall_total_async_s']}s async", file=sys.stderr,
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
