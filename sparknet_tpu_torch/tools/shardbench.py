"""The hybrid-sharding parity gate: six verdicts, any failure exits 1.

    python -m sparknet_tpu_torch.tools.shardbench [--rounds 3]
        [--devices 4] [--batch 16] [--tau 2] [--out FILE]
        [--device cuda|cpu]

The port's copy of the root ``tools/shardbench.py``, with the port's
``--device`` (the card unless the caller asks for the CPU).  LeNet,
``--devices`` positions on the one device, τ=2, seed 0:

1. **Three-strategy bit parity.**  ``shard="auto"`` (``parallel/
   partition.py``'s rule table) gives the same losses and the same
   gathered params, bit for bit, as ``shard="off"``, for ``local_sgd``
   and ``sync`` on a flat layout and ``hierarchical`` on a (2, n/2) pod
   layout.
2. **Codec composition.**  The int8 exchange under the plan equals the
   int8 data-parallel run bit for bit.
3. **Per-shard checkpoint round trip.**  ``shard_checkpoint=True``
   writes a common npz and one tile a shard under the manifest; a fresh
   trainer resumes them with the same params and the same continuation
   loss.
4. **Elastic re-tile.**  The world-N tiles restore into a world-N/2
   trainer (another plan, other tiles) with the params bit for bit, and
   it trains on, finite.
5. **The audit under sharding.**  The [n_pos, 2] fingerprints pass on a
   healthy layout, a flip planted on position 2 is blamed on exactly
   ``[2]``, and the trip's rollback restores a state that passes again.
6. **Boundary-byte shrink.**  The per-position τ-boundary bytes shrink
   under the plan, on lenet and on CaffeNet's shapes (at least 2x at 8
   shards).

Prints one JSON line (the JAX line's keys and ``device``); the ledger
reads it with ``utils/perfledger.py::entries_from_shardbench``.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import sys
import tempfile
import time

import numpy as np

CAFFENET_MIN_SHRINK_X = 2.0   # at 8 shards the analytic value is ~6.3x


def run(rounds: int = 3, devices: int = 4, batch: int = 16, tau: int = 2,
        device: str = "cuda") -> dict:
    """Every verdict; returns the line :func:`main` prints."""
    import torch

    from ..graph.net import Net
    from ..models import lenet
    from ..models.alexnet import caffenet
    from ..parallel import comms, partition
    from ..parallel.mesh import make_pod_mesh
    from ..parallel.trainer import DistributedTrainer, TrainerConfig
    from ..proto import load_solver_prototxt_with_net
    from ..proto.caffe_pb import NetState, Phase
    from ..utils.device import deterministic_cudnn, resolve_device

    dev = resolve_device(device)
    sp = load_solver_prototxt_with_net(
        'base_lr: 0.005\nmomentum: 0.9\nlr_policy: "fixed"\n',
        lenet(batch, batch))

    def batch_of(r):
        rng = np.random.default_rng(4200 + r)
        return {"data": rng.normal(size=(tau, batch, 1, 28, 28)
                                   ).astype(np.float32),
                "label": rng.integers(0, 10, size=(tau, batch)
                                      ).astype(np.float32)}

    def host(tr) -> dict:
        return {k: [b.detach().cpu().numpy() for b in v]
                for k, v in tr.params.items()}

    def sync() -> None:
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    def train(cfg: TrainerConfig, layout=None, n=None) -> dict:
        tr = DistributedTrainer(sp, layout or devices, cfg, seed=0,
                                device=dev)
        losses = []
        t0 = time.perf_counter()
        for r in range(n or rounds):
            losses.append(tr.train_round(batch_of(r)))
        tr.drain()
        sync()
        dt = time.perf_counter() - t0
        return {"trainer": tr, "losses": losses, "params": host(tr),
                "round_s": round(dt / (n or rounds), 4)}

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
    pod = make_pod_mesh(2, devices // 2)
    with deterministic_cudnn():
        # -- 1. dp against sharded, all three strategies ------------------
        parity: dict[str, bool] = {}
        legs: dict[str, dict] = {}
        for strat, layout in (("local_sgd", None), ("sync", None),
                              ("hierarchical", pod)):
            dp = train(TrainerConfig(strategy=strat, tau=tau, shard="off"),
                       layout)
            sh = train(TrainerConfig(strategy=strat, tau=tau,
                                     shard="auto"), layout)
            if sh["trainer"].shard_plan is None:
                failures.append(f"[plan] {strat}: shard='auto' resolved "
                                f"to no plan — nothing was sharded")
            mismatch = bit_identical(dp, sh)
            parity[strat] = not mismatch
            failures += [f"[parity-{strat}] {m}" for m in mismatch]
            legs[strat] = {"dp": dp, "sharded": sh}
        probe = legs["local_sgd"]["sharded"]["trainer"]
        plan, plan_id = probe.shard_plan, probe.shard_plan_id

        # -- 2. the int8 exchange under the plan --------------------------
        int8_dp = train(TrainerConfig(strategy="local_sgd", tau=tau,
                                      comm_codec="int8", shard="off"))
        int8_sh = train(TrainerConfig(strategy="local_sgd", tau=tau,
                                      comm_codec="int8", shard="auto"))
        codec_mismatch = bit_identical(int8_dp, int8_sh)
        failures += [f"[codec-int8] {m}" for m in codec_mismatch]

        # -- 3, 4, 5. the sharded checkpoint, elastic, the audit ----------
        with tempfile.TemporaryDirectory() as ck:
            cfg = TrainerConfig(strategy="local_sgd", tau=tau, shard="auto",
                                shard_checkpoint=True, checkpoint_dir=ck,
                                checkpoint_every=1, checkpoint_keep=8,
                                audit_every=1, elastic=True)
            tr = DistributedTrainer(sp, devices, cfg, seed=0, device=dev)
            for r in range(2):
                tr.train_round(batch_of(r))
            tr.drain()
            consensus = host(tr)
            if not glob.glob(os.path.join(ck, "*.shard*.npz")):
                failures.append("[ckpt] shard_checkpoint=True wrote no "
                                "per-shard npz tiles")
            # 3: a fresh same-world trainer resumes the tiles; only tr
            # keeps writing into ck
            cfg2 = TrainerConfig(strategy="local_sgd", tau=tau,
                                 shard="auto", shard_checkpoint=True,
                                 checkpoint_dir=ck, checkpoint_every=64,
                                 checkpoint_keep=8, audit_every=1,
                                 elastic=True)
            tr2 = DistributedTrainer(sp, devices, cfg2, seed=0, device=dev)
            ckpt_mismatch = bit_identical(
                {"losses": [], "params": consensus},
                {"losses": [], "params": host(tr2)})
            cont_a = tr.train_round(batch_of(2))
            cont_b = tr2.train_round(batch_of(2))
            if np.float32(cont_a).tobytes() != np.float32(cont_b).tobytes():
                ckpt_mismatch.append(
                    f"continuation loss diverges: {cont_a} vs {cont_b}")
            tr.drain()
            tr2.drain()
            ckpt_ok = not ckpt_mismatch
            failures += [f"[ckpt] {m}" for m in ckpt_mismatch]
            # 4: the world-N tiles on a world-N/2 layout (a new plan)
            tr_half = DistributedTrainer(sp, devices // 2, cfg2, seed=0,
                                         device=dev)
            elastic_mismatch = bit_identical(
                {"losses": [], "params": host(tr)},
                {"losses": [], "params": host(tr_half)})
            cont = tr_half.train_round(batch_of(3))
            tr_half.drain()
            if not np.isfinite(list(tr_half.round_losses.values())[-1]
                               if tr_half.round_losses else cont):
                elastic_mismatch.append("re-tiled continuation non-finite")
            elastic_ok = not elastic_mismatch
            failures += [f"[elastic] {m}" for m in elastic_mismatch]
            # 5: a healthy pass, a planted flip blamed, a rollback that
            # passes again
            fps = tr.audit_params()
            audit_msgs = []
            if fps.shape != (devices, 2):
                audit_msgs.append(f"sharded fingerprint shape {fps.shape} "
                                  f"!= ({devices}, 2)")
            if not tr._audit_ok(fps):
                audit_msgs.append(f"healthy layout failed the audit: {fps}")
            tr._inject_bitflip(2)
            culprits = tr._audit_culprits(tr.audit_params())
            if culprits != [2]:
                audit_msgs.append(f"planted flip on replica 2 blamed "
                                  f"{culprits}")
            nan = tr.train_round(batch_of(4))     # trips, rolls back
            if not np.isnan(nan):
                audit_msgs.append("tripped round did not report nan")
            if not tr._audit_ok(tr.audit_params()):
                audit_msgs.append("audit still failing after rollback")
            audit_ok = not audit_msgs
            failures += [f"[audit] {m}" for m in audit_msgs]

    # -- 6. the boundary and exchange bytes --------------------------------
    bytes_dp = partition.boundary_bytes_per_chip(probe.params, None)
    bytes_sh = partition.boundary_bytes_per_chip(probe.params, plan)
    shrink = round(bytes_dp / max(bytes_sh, 1), 3)
    none = comms.get_codec("none")
    ex_dp = comms.exchange_bytes(none, probe.params, devices)
    ex_sh = comms.sharded_exchange_bytes(none, probe.params, devices, plan)
    if not bytes_sh < bytes_dp:
        failures.append(f"[bytes] plan did not shrink the boundary: "
                        f"{bytes_sh} vs {bytes_dp}")
    # CaffeNet's shapes, FC-dominated: meta tensors, no memory
    cnet = Net(caffenet(8, 8), NetState(Phase.TRAIN))
    cnet_shapes = {k: [torch.empty(s, device="meta") for s in v]
                   for k, v in cnet.param_shapes().items()}
    cnet_plan = partition.resolve_plan("auto", cnet_shapes, axis="data",
                                       n_shards=8)
    cnet_dp = partition.boundary_bytes_per_chip(cnet_shapes, None)
    cnet_sh = partition.boundary_bytes_per_chip(cnet_shapes, cnet_plan)
    cnet_shrink = round(cnet_dp / max(cnet_sh, 1), 3)
    if cnet_plan is None or cnet_shrink < CAFFENET_MIN_SHRINK_X:
        failures.append(f"[bytes] caffenet-class shrink {cnet_shrink}x "
                        f"< {CAFFENET_MIN_SHRINK_X}x at 8 shards")
    kind = (torch.cuda.get_device_name(dev) if dev.type == "cuda"
            else "cpu")
    return {
        "shardbench": True,   # the ledger's sniff key
        "ok": not failures,
        "failures": failures,
        "model": "lenet",
        "rounds": rounds,
        "tau": tau,
        "batch": batch,
        "devices": devices,
        "device": f"{dev.type}/{kind}",
        "plan": plan_id,
        "plan_dims": plan.dims_dict() if plan else {},
        "parity": parity,
        "codec_int8_parity": not codec_mismatch,
        "ckpt_roundtrip_ok": ckpt_ok,
        "elastic_ok": elastic_ok,
        "audit_ok": audit_ok,
        "dp": {"round_s": legs["local_sgd"]["dp"]["round_s"],
               "boundary_bytes_per_chip": bytes_dp,
               "exchange_bytes": ex_dp},
        "sharded": {"round_s": legs["local_sgd"]["sharded"]["round_s"],
                    "boundary_bytes_per_chip": bytes_sh,
                    "exchange_bytes": ex_sh},
        "shard_bytes_shrink_x": shrink,
        "caffenet": {"plan": partition.shard_plan_id(cnet_plan),
                     "boundary_bytes_dp": cnet_dp,
                     "boundary_bytes_sharded": cnet_sh,
                     "shrink_x": cnet_shrink},
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--devices", type=int, default=4,
                    help="positions on the one device; 4 keeps lenet's "
                         "500-unit ip1 divisible")
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--tau", type=int, default=2)
    ap.add_argument("--out", default=None)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    result = run(args.rounds, args.devices, args.batch, args.tau,
                 args.device)
    line = json.dumps(result)
    print(line, flush=True)
    if args.out:
        with open(args.out, "w") as f:
            f.write(line + "\n")
    if result["failures"]:
        print(f"[shardbench] GATE FAILURE: {result['failures']}",
              file=sys.stderr, flush=True)
        return 1
    print(f"[shardbench] all gates hold: 3-strategy bit parity, int8 "
          f"composition, per-shard ckpt roundtrip, elastic re-tile, "
          f"shard-aware audit; boundary bytes {result['shard_bytes_shrink_x']}"
          f"x smaller (caffenet-class {result['caffenet']['shrink_x']}x "
          f"at 8 shards)", file=sys.stderr, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
