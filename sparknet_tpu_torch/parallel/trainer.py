"""SparkNet's round over N workers on one card: τ-step local SGD with
weight averaging, synchronous SGD, or both composed (hierarchical), with
compressed exchange, round checkpoints, the numerical guard and the
harvest lag.

The port's counterpart of ``sparknet_tpu/parallel/trainer.py``:

- ``"local_sgd"`` (``local_sgd_body``, :657-688; the reference's Spark
  round loop, src/main/scala/apps/ImageNetApp.scala:100-182): every one
  of N workers starts a round from the master params, runs τ SGD steps on
  its own slice of the round's minibatches with its own solver state
  (momentum history, kept across rounds), and the master params become
  the mean of the workers' params.
- ``"sync"`` (``make_psum_step``/``sync_body``, :577-617; Caffe's
  P2PSync): in each of τ steps every worker computes its loss and
  gradients on its rows over ``iter_size`` micro-batches, the gradients
  and losses are averaged over workers, ``preprocess_grads`` runs on the
  average and one update moves one shared set of params and solver
  state.  Every worker's forward starts from the step's params, and the
  blobs of forward-state layers (BatchNorm's running statistics) become
  the mean of what the workers' forwards wrote (:591-597).
- ``"hierarchical"`` (``hierarchical_body``, :690-728): the two composed
  on a (host, chip) layout (``parallel/mesh.py::make_pod_mesh``).  Each
  host runs the ``sync`` step over its chips, with one solver state per
  host, and at the τ boundary the params are averaged over hosts.

The round's loss is the mean over workers and steps.  On one card the N
workers run one after another, each with one CPU ``torch.Generator`` for
its Dropout masks (and, with ``device_preprocess``, one more for its crop
offsets); batching the workers is later work.  Every step runs in full
f32 (TF32 off, ``utils.device.full_f32``), as the JAX trainer's f32 nets
do on the CPU.

With ``comm_codec`` other than ``"none"`` (``local_sgd`` and
``hierarchical``), the τ-boundary average goes through
``parallel/comms.py``: each tier member's weight delta against the
broadcast params, plus its error-feedback residual, is encoded, the
payload exchanged (on one card: passed as it is), decoded and averaged.
``comm_codec="none"`` never enters that path.

Round checkpoints (``checkpoint_dir``) keep the JAX package's files
(``ckpt_round_%08d.npz`` and a ``manifest_%08d.json`` naming its sha256,
written tmp+rename, the manifest last, pruned to ``checkpoint_keep``),
so a checkpoint written by either package resumes in the other; a fresh
trainer resumes the newest valid one.  ``guard_numerics`` rolls a round
with a non-finite or spiking loss, or non-finite params, back to the
newest checkpoint; ``harvest_lag`` keeps the loss and that verdict on
the device and reads them K rounds late.

Rounds come from the host (numpy arrays, copied to the card per
micro-batch) or, through :meth:`DistributedTrainer.input_feed`, already
on the device, staged by ``data/prefetch.py::DeviceFeed``.
:func:`device_crop_mirror_mean` moves the random crop, the mirror and the
mean into the round (``TrainerConfig.device_preprocess``), so the host
ships raw images.  Every one of Caffe's six update rules trains here
(``solvers/update_rules.py``); ``snapshot``/``restore`` write and read the
JAX package's checkpoint layout, each rule's state slots under their JAX
names.

Positions (the JAX package's mesh positions, :371-391, :626-730).  A JAX
position holds its own copy of the params between rounds.  When a
partition plan resolves (``shard``, ``parallel/partition.py``), or
``audit_every > 0``, or the gang has more than one process, the trainer
keeps one resident tree per position it holds: the replicated leaves
whole and, under a plan, its own tile of each sharded leaf (a flat layout
shards over its ``n_workers`` positions, ``hierarchical`` over its chips,
a host's chip c holding tile c).  Each worker starts its round from its
own tree, the sharded leaves gathered from the tiles of its axis
(``torch.cat``); at the τ boundary each position keeps its own tile of
the mean (``narrow``) and shares the replicated leaves of the mean until
one of its own is rewritten, as a flipped bit is.  ``sync`` runs
positions with identical trees as one group and a divergent position on
its own, so a rotted copy stays resident as it does on a mesh.
Otherwise the one-copy path runs as before, byte for byte.
``self.params`` is the logical tree either way: the mean, with full
leaves.

The gang.  With a process group (``parallel/cluster.py``) each process
runs its own positions, a contiguous block in position order (whole hosts
under ``hierarchical``), in turn as one process does.  Wherever the round
takes a mean over positions, the processes all-gather the positions'
trees (under ``sync`` each step's gradients and stateful blobs; under a
codec the encoded payload, the ``comm_allreduce`` stage) and every
process computes the same mean over the same stacked values in position
order, so the gang's params equal the one-process round's bit for bit
and every process holds the same bits.  ``test()`` gathers its scores
and sums them in worker order; the checkpoint blob gathers each tier's
state, residual and generator rows from their owners, and process 0
writes while the others wait at a barrier.

The cross-replica audit (``audit_every``, :484-530, :938-966,
:1231-1395).  Before every ``audit_every``-th round each position
fingerprints its resident tree: every float leaf cast to f32 and read as
uint32, integer leaves cast to uint32, all summed mod 2**32 (in int64,
order-free, so the JAX trainer's value exactly); under a plan two
columns, the replicated leaves and the resident tile.  The culprits are
the positions off the majority, mesh-wide and, for the tile column,
within the positions that hold the same tile (a chip column under
``hierarchical``).  A mismatch rolls back to the newest checkpoint at or
before the last audit that passed, records ``audit_mismatch`` and dumps
the flight recorder.  ``bitflip_params@rank:R@round:N`` flips bit 22 of
the first element of position R's copy of the first non-empty f32 leaf,
in sorted layer order (:1370-1395); in a gang only the process that
holds R flips it.

Round checkpoints under a plan carry ``shard_plan`` (the trainer's
``shard_plan_id``) in the blob and the manifest; with
``shard_checkpoint`` the sharded leaves go to one npz tile a shard
(``ckpt_round_%08d.shard%02d.npz``, each sha256 in the manifest with
``shard_dims``) and resume joins them (:1494-1535, :1707-1770,
:1857-1876).  ``remat`` (ROADMAP A5) raises.

Telemetry (``utils/telemetry.py``, the JAX package's names): the
``trainer.round``, ``trainer.harvest`` and ``trainer.ckpt_submit`` spans;
``trainer_rounds_total``, ``trainer_guard_trips_total``,
``trainer_audit_trips_total``, ``trainer_stall_seconds{comp}`` and
``trainer_pending_rounds``; the ``guard_trip``, ``audit_mismatch`` and
``resume`` flight events.  A span is host time: the
round's span closes where the round already waits for the card (the
loss fetch without a harvest lag) or, with a lag, when its work is
enqueued.  The plane adds no synchronisation to a round.  While ``SPARKNET_HEARTBEAT_DIR`` is set the trainer
beats (``parallel/health.py``) at ``init``, ``round_start`` and
``round_end``, the last with the JAX trainer's extras: ``stall_s``, the
trip counters and the feed's stats.
"""

from __future__ import annotations

import collections
import dataclasses
import glob
import hashlib
import json
import os
import sys
import time
from typing import Any, Iterator, Mapping

import numpy as np
import torch

from ..graph.net import Net, Params
from ..proto.caffe_pb import NetState, Phase, SolverParameter
from ..solvers.lr_policies import learning_rate
from ..solvers.step import make_step_fns
from ..solvers.update_rules import make_update_rule, preprocess_grads
from ..utils import telemetry
from ..utils.device import full_f32, resolve_device
from . import cluster, comms, partition
from .mesh import CHIP_AXIS, DATA_AXIS, HOST_AXIS, Layout, make_mesh

STRATEGIES = ("local_sgd", "sync", "hierarchical")
COMM_STAGES = ("comm_encode", "comm_allreduce", "comm_decode")


@dataclasses.dataclass(frozen=True)
class TrainerConfig:
    """The JAX package's ``TrainerConfig`` (trainer.py:88-228), field for
    field and default for default, except ``donate`` (XLA buffer
    donation, which has no counterpart here)."""
    strategy: str = "local_sgd"   # "local_sgd" | "sync" | "hierarchical"
    tau: int = 1                  # steps per round
    # A callable (micro_batch_dict, generator) -> micro_batch_dict run on
    # each worker's micro-batch before its step, on the device; build one
    # with ``device_crop_mirror_mean``.
    device_preprocess: Any | None = None
    remat: bool = False           # not ported (ROADMAP A5)
    # round checkpoints: every ``checkpoint_every`` completed rounds into
    # ``checkpoint_dir``, the newest ``checkpoint_keep`` kept; a fresh
    # trainer resumes the newest valid one
    checkpoint_dir: str | None = None
    checkpoint_every: int = 1
    checkpoint_keep: int = 3
    # resume a checkpoint of another worker (or host) count: stacked
    # per-tier state and residuals re-tier, row i from saved row i mod n
    elastic: bool = False
    # roll a round with a non-finite (or, with loss_spike_factor > 0,
    # spiking) loss or non-finite params back to the newest checkpoint;
    # each trip multiplies lr_scale by guard_lr_backoff, and trip
    # guard_max_trips + 1 raises TrainingDivergedError
    guard_numerics: bool = False
    loss_spike_factor: float = 0.0
    guard_lr_backoff: float = 1.0
    guard_max_trips: int = 3
    # every audit_every rounds (0: off), before the round runs, each
    # position fingerprints its resident params and the positions off
    # the majority roll the trainer back; needs checkpoint_dir
    audit_every: int = 0
    # K > 0: the loss and the guard's verdict stay on the device and are
    # read K rounds late; drain() reads the rest
    harvest_lag: int = 0
    # write round checkpoints on a background thread
    # (SPARKNET_ASYNC_CKPT=0 overrides to synchronous)
    async_checkpoint: bool = True
    # the τ-boundary exchange's wire format (parallel/comms.py); "none"
    # is the plain average.  local_sgd and hierarchical only.
    comm_codec: str = "none"
    # no host synchronisation between encode, exchange and decode (the
    # same results bit for bit; stall_s charges the stages only without)
    comm_overlap: bool = False
    # the partition rule table (parallel/partition.py): "off", "auto"
    # (FC weights shard across the layout's fast axis) or a JSON table
    shard: str = "off"
    # under a plan: round checkpoints as one npz tile a shard
    shard_checkpoint: bool = False


class TrainingDivergedError(RuntimeError):
    """The numerical guard tripped and could not recover: no checkpoint
    to roll back to, or more than ``guard_max_trips`` trips."""


def _not_ported(config: TrainerConfig) -> list[str]:
    """The settings of ``config`` this port does not implement, each
    with the ROADMAP item it waits for."""
    bad = []
    if config.remat:
        bad.append("remat (ROADMAP A5)")
    return bad


def comm_config_from_env(base: TrainerConfig | None = None
                         ) -> TrainerConfig:
    """``base`` (or a default config) with the round's shape from the
    knobs that are set: ``SPARKNET_TAU``, ``SPARKNET_COMM_CODEC``,
    ``SPARKNET_COMM_OVERLAP``, ``SPARKNET_SHARD`` (off | auto | a rule
    table's path) and ``SPARKNET_SHARD_CKPT`` (the JAX package's
    trainer.py:286-315).  Unset knobs leave ``base`` as it is."""
    from ..utils import knobs
    cfg = base or TrainerConfig()
    tau = knobs.get_int("SPARKNET_TAU", 0)
    if tau > 0:
        cfg = dataclasses.replace(cfg, tau=tau)
    codec = knobs.get_str("SPARKNET_COMM_CODEC", "")
    if codec:
        cfg = dataclasses.replace(cfg, comm_codec=codec)
    if knobs.is_set("SPARKNET_COMM_OVERLAP"):
        cfg = dataclasses.replace(
            cfg, comm_overlap=knobs.get_bool("SPARKNET_COMM_OVERLAP", False))
    shard = knobs.get_str("SPARKNET_SHARD", "")
    if shard:
        cfg = dataclasses.replace(cfg, shard=shard)
    if knobs.is_set("SPARKNET_SHARD_CKPT"):
        cfg = dataclasses.replace(
            cfg, shard_checkpoint=knobs.get_bool("SPARKNET_SHARD_CKPT",
                                                 False))
    return cfg


def _mean(trees: list[Params]) -> Params:
    """The leafwise mean of ``trees``."""
    return {k: [torch.stack([t[k][i] for t in trees]).mean(0)
                for i in range(len(blobs))]
            for k, blobs in trees[0].items()}


def _stack(trees: list[Params]) -> Params:
    return {k: [torch.stack([t[k][i] for t in trees])
                for i in range(len(blobs))]
            for k, blobs in trees[0].items()}


def _poison(v):
    """NaNs in place of a floating input (``nan_inject``)."""
    if isinstance(v, torch.Tensor):
        return torch.full_like(v, float("nan")) if v.is_floating_point() \
            else v
    v = np.asarray(v)
    return np.full_like(v, np.nan) if np.issubdtype(v.dtype, np.floating) \
        else v


def _retier(x: np.ndarray, n: int) -> np.ndarray:
    """Rows of a stacked per-tier array for ``n`` tiers: row i from saved
    row i mod saved_n (the JAX package's ``_retier_state``, :1539)."""
    x = np.asarray(x)
    return x[np.arange(n) % x.shape[0]]


def _sha256_file(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


def _manifest_round(path: str) -> int:
    stem = os.path.basename(path)
    try:
        return int(stem[len("manifest_"):-len(".json")])
    except ValueError:
        return -1


def _copy(params: Params) -> Params:
    return {k: [b.detach().clone() for b in v] for k, v in params.items()}


def _leaves(tree) -> list[torch.Tensor]:
    """The tensors of a tree of dicts and lists, in order."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        tree = list(tree.values())
    return [t for v in tree for t in _leaves(v)]


def _unleaves(like, it):
    """A tree shaped like ``like`` from an iterator of its leaves."""
    if isinstance(like, torch.Tensor):
        return next(it)
    if isinstance(like, dict):
        return {k: _unleaves(v, it) for k, v in like.items()}
    return [_unleaves(v, it) for v in like]


def _leaf_bits(leaf: torch.Tensor) -> torch.Tensor | None:
    """The leaf's elements as uint32 bit patterns summed, in int64 (the
    JAX trainer's ``leaf_sum``, :1250-1259, before its mod 2**32): a
    float leaf cast to f32 and read as uint32, an integer one cast to
    uint32; None for any other type."""
    leaf = leaf.detach()
    if leaf.is_floating_point():
        bits = leaf.float().contiguous().view(torch.int32).to(torch.int64)
    elif leaf.dtype != torch.bool and not leaf.is_complex():
        bits = leaf.to(torch.int64)
    else:
        return None
    return (bits & 0xFFFFFFFF).sum()


def crop_mirror_mean(data: torch.Tensor, ys: torch.Tensor, xs: torch.Tensor,
                     flips: torch.Tensor, crop: int,
                     mean: torch.Tensor | None = None) -> torch.Tensor:
    """Crop each image of an (N, C, H, W) batch to (crop, crop) at its
    offsets ``ys``, ``xs`` (N,), mirror those whose ``flips`` is set, and
    subtract ``mean``: one gather by per-sample indices and one
    subtraction, on ``data``'s device, with no host sync.

    ``mean`` of the image's size (H, W) is subtracted at each window
    (before the crop, as Caffe indexes the mean); of the crop's size
    after the crop, at unmirrored coordinates (data_transformer.cpp
    mirrors the subtracted result); any other size raises.  The output
    is f32 whatever ``data``'s dtype; its values equal the JAX package's
    ``device_crop_mirror_mean`` bit for bit at the same offsets."""
    n, c, h, w = data.shape
    dev = data.device
    if mean is not None and mean.dim() >= 2 and \
            tuple(mean.shape[-2:]) not in ((h, w), (crop, crop)):
        raise ValueError(
            f"device mean shape {tuple(mean.shape)} matches neither the "
            f"full image ({h}, {w}) nor the crop ({crop}, {crop})")
    r = torch.arange(crop, device=dev)
    rows = r.expand(n, crop)                               # window rows
    cols = torch.where(flips.to(dev, torch.bool)[:, None],
                       crop - 1 - r, r)                    # mirrored cols
    local = (rows[:, :, None] * crop + cols[:, None, :]).reshape(n, 1, -1)
    full = ((ys.to(dev)[:, None] + rows)[:, :, None] * w
            + (xs.to(dev)[:, None] + cols)[:, None, :]).reshape(n, 1, -1)
    out = data.reshape(n, c, h * w).gather(
        2, full.expand(n, c, -1)).to(torch.float32)
    if mean is not None:
        m = mean.to(dev, torch.float32)
        if m.dim() >= 2:
            idx = full if tuple(m.shape[-2:]) == (h, w) else local
            # (C' or 1, H'·W') gathered at each sample's indices, then
            # (n, C', crop²): no copy of the mean per sample
            m = m.reshape(-1, m.shape[-2] * m.shape[-1])[:, idx[:, 0]]
            m = m.transpose(0, 1)
        out = out - m
    return out.reshape(n, c, crop, crop)


class DeviceCropMirrorMean:
    """A ``TrainerConfig.device_preprocess``: the random crop, the mirror
    and the mean of :func:`crop_mirror_mean` on ``field``, with the
    offsets drawn from the worker's CPU generator in the JAX package's
    order (ys, xs, flips) and copied to the device in one small
    asynchronous copy.  Drawing on the CPU gives the card's round the
    CPU's offsets."""

    def __init__(self, crop: int, mirror: bool = True, mean=None,
                 field: str = "data"):
        self.crop, self.mirror, self.field = crop, mirror, field
        self.mean = (None if mean is None
                     else torch.as_tensor(np.asarray(mean, np.float32)))
        self._mean_on: dict[torch.device, torch.Tensor] = {}

    def draw(self, n: int, h: int, w: int,
             gen: torch.Generator) -> torch.Tensor:
        """(3, n) int64 offsets: ys, xs, flips."""
        ys = torch.randint(0, h - self.crop + 1, (n,), generator=gen)
        xs = torch.randint(0, w - self.crop + 1, (n,), generator=gen)
        flips = (torch.randint(0, 2, (n,), generator=gen) if self.mirror
                 else torch.zeros(n, dtype=torch.int64))
        return torch.stack([ys, xs, flips])

    def __call__(self, micro: Mapping[str, torch.Tensor],
                 gen: torch.Generator) -> dict[str, torch.Tensor]:
        data = micro[self.field]
        lead = data.shape[:-3]
        c, h, w = data.shape[-3:]
        flat = data.reshape(-1, c, h, w)
        offs = self.draw(flat.shape[0], h, w, gen)
        if flat.is_cuda:
            offs = offs.pin_memory().to(flat.device, non_blocking=True)
        mean = None
        if self.mean is not None:
            mean = self._mean_on.get(flat.device)
            if mean is None:
                mean = self._mean_on[flat.device] = self.mean.to(flat.device)
        out = crop_mirror_mean(flat, offs[0], offs[1], offs[2], self.crop,
                               mean)
        return {**micro, self.field: out.reshape(
            lead + (c, self.crop, self.crop))}


def device_crop_mirror_mean(crop: int, mirror: bool = True, mean=None,
                            field: str = "data") -> DeviceCropMirrorMean:
    """Build a ``TrainerConfig.device_preprocess``: random crop to (crop,
    crop), horizontal mirror and mean subtraction on the device, the
    port's counterpart of the JAX package's ``device_crop_mirror_mean``
    (parallel/trainer.py:237-283).  The host then ships raw full-size
    images."""
    return DeviceCropMirrorMean(crop, mirror=mirror, mean=mean, field=field)


class DistributedTrainer:
    """Master params, solver state (one per worker under ``local_sgd``,
    one per host under ``hierarchical``, one shared under ``sync``) and
    the round loop over logical workers on ``device``.  ``n_workers`` is
    a worker count (a flat layout, ``make_mesh(n)``) or a
    ``parallel.mesh`` layout; ``hierarchical`` needs
    ``make_pod_mesh(hosts, chips)``."""

    def __init__(self, sp: SolverParameter, n_workers: int | Layout = 1,
                 config: TrainerConfig | None = None, *, seed: int = 0,
                 device: str | torch.device = "cuda"):
        self.sp = sp
        cfg = self.config = config or TrainerConfig()
        if cfg.strategy not in STRATEGIES:
            raise ValueError(f"unknown strategy {cfg.strategy!r}")
        bad = _not_ported(cfg)
        if bad:
            raise NotImplementedError(f"not ported yet: {', '.join(bad)}")
        # "none" stays off the exchange machinery: the plain average
        self._codec = (None if cfg.comm_codec == "none"
                       else comms.get_codec(cfg.comm_codec))
        if self._codec is not None and cfg.strategy == "sync":
            raise ValueError(
                f"comm_codec={cfg.comm_codec!r} needs a τ-boundary weight "
                f"exchange to compress; strategy 'sync' exchanges per-step "
                f"gradients (use local_sgd or hierarchical, or "
                f"comm_codec='none')")
        layout = n_workers
        if isinstance(layout, int):
            if layout < 1:
                raise ValueError(f"n_workers must be >= 1, got {layout}")
            layout = make_mesh(layout)
        shape = layout.shape
        if cfg.strategy == "hierarchical":
            if HOST_AXIS not in shape or CHIP_AXIS not in shape:
                raise ValueError(
                    "hierarchical strategy needs a (host, chip) layout: "
                    "build it with make_pod_mesh()")
            self.n_hosts, self.n_chips = shape[HOST_AXIS], shape[CHIP_AXIS]
        elif DATA_AXIS not in shape:
            raise ValueError(
                f"strategy {cfg.strategy!r} needs a flat layout "
                f"(make_mesh), got {shape}")
        if cfg.tau < 1:
            raise ValueError(f"tau must be >= 1, got {cfg.tau}")
        if cfg.harvest_lag < 0:
            raise ValueError(
                f"harvest_lag must be >= 0, got {cfg.harvest_lag}")
        if cfg.checkpoint_every < 1:
            raise ValueError(f"checkpoint_every must be >= 1, got "
                             f"{cfg.checkpoint_every}")
        if cfg.guard_numerics and not cfg.checkpoint_dir:
            raise ValueError("guard_numerics needs checkpoint_dir: rollback "
                             "is the guard's only recovery action")
        if cfg.audit_every < 0:
            raise ValueError(
                f"audit_every must be >= 0, got {cfg.audit_every}")
        if cfg.audit_every:
            if not cfg.checkpoint_dir:
                raise ValueError(
                    "audit_every needs checkpoint_dir — rollback is the "
                    "audit's only recovery action")
            horizon = cfg.checkpoint_every * max(cfg.checkpoint_keep - 1, 0)
            if horizon < cfg.audit_every:
                raise ValueError(
                    f"audit_every={cfg.audit_every} outruns the "
                    f"checkpoint retention (checkpoint_every="
                    f"{cfg.checkpoint_every} x (checkpoint_keep="
                    f"{cfg.checkpoint_keep} - 1) = {horizon} "
                    f"rounds): by the time a mismatch is detected, every "
                    f"pre-divergence checkpoint may be pruned")
        if cfg.harvest_lag and (cfg.guard_numerics or cfg.audit_every):
            # a poison at round r surfaces up to harvest_lag rounds (plus
            # the audit's cadence) later; the newest checkpoint before it
            # must outlive the pruning of the checkpoints written meanwhile
            horizon = cfg.checkpoint_every * max(cfg.checkpoint_keep - 1, 0)
            need = (cfg.harvest_lag + cfg.audit_every
                    + cfg.checkpoint_every - 1)
            if horizon < need:
                raise ValueError(
                    f"harvest_lag={cfg.harvest_lag} outruns the checkpoint "
                    f"retention (checkpoint_every={cfg.checkpoint_every} x "
                    f"(checkpoint_keep={cfg.checkpoint_keep} - 1) = "
                    f"{horizon} < {need} rounds of detection latency): "
                    f"raise checkpoint_keep or lower harvest_lag")
        self.mesh = layout
        self.n_workers = layout.n_workers
        # the gang: this process runs positions [first, first + n_local)
        self._procs, self._rank = (cluster.process_count(),
                                   cluster.process_index())
        if self.n_workers % self._procs:
            raise ValueError(f"{self.n_workers} workers do not divide over "
                             f"{self._procs} processes")
        n_local = self.n_workers // self._procs
        if cfg.strategy == "hierarchical" and n_local % self.n_chips:
            raise ValueError(
                f"a process must hold whole hosts: {n_local} workers a "
                f"process, {self.n_chips} chips a host")
        self._local = range(self._rank * n_local,
                            (self._rank + 1) * n_local)
        self.device = resolve_device(device)
        net_param = sp.net_param or sp.train_net_param
        if net_param is None:
            raise ValueError("SolverParameter carries no net definition")
        self.train_net = Net(net_param, NetState(Phase.TRAIN))
        self.test_net = Net(net_param, NetState(Phase.TEST))
        self.rule = make_update_rule(sp)
        # one resident tree per position held (module docstring), or None
        # on the one-copy path
        self._resident: dict[int, Params] | None = None
        self.params = self.train_net.init(
            torch.Generator().manual_seed(seed), device=self.device)
        # the partition plan over the layout's fast axis: the chips under
        # hierarchical, the one data axis otherwise
        if cfg.strategy == "hierarchical":
            axis, n_shards = CHIP_AXIS, self.n_chips
        else:
            axis, n_shards = DATA_AXIS, self.n_workers
        self.shard_plan = partition.resolve_plan(
            cfg.shard, self.params, axis=axis, n_shards=n_shards)
        self.shard_plan_id = partition.shard_plan_id(self.shard_plan)
        if (self.shard_plan is not None or cfg.audit_every
                or self._procs > 1):
            self._ensure_resident()
        self.state = self.init_state()
        self._lr_mults = self.train_net.lr_mult_tree(self.params)
        self._decay_mults = self.train_net.decay_mult_tree(self.params)
        _, self._local_update, self._accum = make_step_fns(
            sp, self.train_net, self.rule, self._lr_mults,
            self._decay_mults)
        # the storage keys of forward-state layers' blobs (BatchNorm's
        # running statistics), which sync re-averages every step
        self._state_keys = sorted({
            k for n in self.train_net.nodes if n.impl.has_state
            for k in n.owner_keys()})
        # per worker, CPU generators whatever the device (the same draws
        # on the card and on the CPU): its Dropout masks (ops/neuron.py),
        # and its crop offsets under device_preprocess
        self.generators = [torch.Generator().manual_seed(seed * 7919 + w + 1)
                           for w in range(self.n_workers)]
        self.crop_generators = [
            torch.Generator().manual_seed(seed * 7919 + 104729 + w)
            for w in range(self.n_workers)]
        self.iter = 0
        self.round = 0
        self.lr_scale = 1.0
        self.round_losses: dict[int, float] = {}
        self.round_seconds: dict[int, float] = {}
        # each worker's params at the end of the last local_sgd round,
        # before the average: what the master params are the mean of
        # (empty under sync and hierarchical)
        self.worker_params: list[Params] = []
        # the FeedStats of the newest input_feed()
        self.feed_stats = None
        # per tier, the error-feedback residual of the compressed
        # exchange, stacked [n_tier, ...] like the JAX package's
        self.comm_residual: Params | None = (
            self._zero_residual() if self._codec is not None else None)
        # round checkpoints, the guard and the harvest lag
        self.data_cursor: Any = None
        self.resumed: dict[str, Any] | None = None
        self.guard_trips = 0
        # the audit: its trips, and the newest round whose audit passed
        # (the rollback horizon)
        self.audit_trips = 0
        self._last_audit_ok = 0
        self._loss_history: list[float] = []
        self._pending: collections.deque = collections.deque()
        self._ckpt_writer = None
        # host seconds the loop waited, by what it waited for
        self.stall_s = {"loss_fetch": 0.0, "finite_check": 0.0,
                        "audit_fetch": 0.0, "checkpoint": 0.0,
                        **{k: 0.0 for k in COMM_STAGES}}
        # telemetry handles (shared no-ops under SPARKNET_TELEMETRY=0)
        reg = telemetry.get_registry()
        self._m_rounds = reg.counter(
            "trainer_rounds_total", "training rounds run (replays included)")
        self._m_guard = reg.counter(
            "trainer_guard_trips_total", "numerical-guard rollbacks")
        self._m_audit = reg.counter(
            "trainer_audit_trips_total", "cross-replica audit rollbacks")
        self._m_stall = reg.gauge(
            "trainer_stall_seconds", "cumulative host stall by component")
        self._m_pending = reg.gauge(
            "trainer_pending_rounds", "in-flight rounds awaiting harvest")
        if cfg.checkpoint_dir:
            self.resumed = self.resume_latest(cfg.checkpoint_dir)
            if (cfg.guard_numerics or cfg.audit_every) \
                    and self.resumed is None:
                # a baseline, so the very first round can roll back
                self.save_round_checkpoint()
        from . import health
        health.maybe_beat(self.round, "init")

    def _state_tier(self) -> int:
        """Solver states (and residuals) kept: one per host under
        ``hierarchical``, one per worker otherwise."""
        if self.config.strategy == "hierarchical":
            return self.n_hosts
        return self.n_workers

    def init_state(self):
        """Fresh solver state for the current params: a list with one per
        worker under ``local_sgd``, one per host under ``hierarchical``,
        one shared state under ``sync``."""
        if self.config.strategy == "sync":
            return self.rule.init(self.params)
        return [self.rule.init(self.params)
                for _ in range(self._state_tier())]

    def _zero_residual(self) -> Params:
        n = self._state_tier()
        return {k: [torch.zeros((n,) + tuple(b.shape), dtype=torch.float32,
                                device=self.device) for b in blobs]
                for k, blobs in self.params.items()}

    # -- positions and their resident trees ------------------------------
    @property
    def params(self) -> Params:
        """The logical params: full leaves, the mean of the last round."""
        return self._params

    @params.setter
    def params(self, tree: Params) -> None:
        self._params = tree
        if self._resident is not None:
            self._reside({w: tree for w in self._local})

    def _ensure_resident(self) -> None:
        """Keep one resident tree per position from here on, each made
        from the logical params."""
        if self._resident is None:
            self._resident = {}
            self._reside({w: self._params for w in self._local})

    def _tile_index(self, w: int) -> int:
        """The tile position ``w`` holds: its chip under hierarchical,
        itself on a flat layout."""
        if self.config.strategy == "hierarchical":
            return w % self.n_chips
        return w

    def _reside(self, trees: Mapping[int, Params]) -> None:
        """Position w keeps ``trees[w]``: its replicated leaves as they
        are (shared until one is rewritten), its own tile of each sharded
        leaf in storage of its own."""
        plan = self.shard_plan
        for w, tree in trees.items():
            if plan is None:
                self._resident[w] = {k: list(v) for k, v in tree.items()}
                continue
            own = plan.take_shard(tree, self._tile_index(w))
            self._resident[w] = {
                k: [b.clone() if plan.dim_of(f"{k}/{i}") is not None else b
                    for i, b in enumerate(v)] for k, v in own.items()}

    def _gather_group(self, w: int) -> range:
        """The positions whose tiles widen worker ``w``'s sharded leaves:
        its host's chips under hierarchical, every position otherwise."""
        if self.config.strategy == "hierarchical":
            h = w // self.n_chips
            return range(h * self.n_chips, (h + 1) * self.n_chips)
        return range(self.n_workers)

    def _tiles(self) -> dict[int, Params]:
        """Every position's resident tree for a gather; another process's
        positions carry only their tiles, gathered from it."""
        if self._procs == 1 or self.config.strategy == "hierarchical":
            return self._resident
        plan = self.shard_plan
        keys = [(k, i) for k, blobs in self._params.items()
                for i in range(len(blobs))
                if plan.dim_of(f"{k}/{i}") is not None]
        rows = cluster.all_gather_tensors(
            [self._resident[w][k][i] for w in self._local for k, i in keys])
        out = {}
        n = len(self._local)
        for r, row in enumerate(rows):
            it = iter(row)
            for j in range(n):
                tree = {k: [None] * len(v) for k, v in self._params.items()}
                for k, i in keys:
                    tree[k][i] = next(it)
                out[r * n + j] = tree
        return out

    def _starts(self, workers, share: bool) -> dict[int, Params]:
        """Each worker's params to start the round from, in storage the
        round may update in place: its resident tree with the sharded
        leaves gathered.  With ``share`` the workers whose trees are the
        same share one copy (the groups of ``_psum_steps``)."""
        plan = self.shard_plan
        tiles = self._tiles() if plan is not None else None
        full: dict[tuple, Params] = {}
        copies: dict[tuple, Params] = {}
        out = {}
        for w in workers:
            res = self._resident[w]
            group = self._gather_group(w)
            key = (tuple(id(b) for k, blobs in res.items()
                         for i, b in enumerate(blobs)
                         if plan is None or plan.dim_of(f"{k}/{i}") is None),
                   group.start)
            if key not in full:
                full[key] = res if plan is None else plan.gather(
                    res, [tiles[p] for p in group])
            if not share:
                out[w] = _copy(full[key])
                continue
            if key not in copies:
                copies[key] = _copy(full[key])
            out[w] = copies[key]
        return out

    def _gather_rows(self, rows: list) -> list:
        """Every process's ``rows`` (trees or tensors, the same structure
        in every process), concatenated in rank order: the positions' (or
        hosts') values in position order.  Alone, ``rows`` as it is."""
        if self._procs == 1:
            return list(rows)
        got = cluster.all_gather_tensors(_leaves(list(rows)))
        out = []
        for part in got:
            out += _unleaves(list(rows), iter(part))
        return out

    @property
    def batches_per_round(self) -> int:
        """Minibatches one round consumes: τ steps x iter_size
        micro-batches (reference: solver.cpp:221-224)."""
        return self.config.tau * self.sp.iter_size

    def input_feed(self, rounds: Iterator[Mapping[str, Any]],
                   depth: int | None = None, stats=None,
                   stall_timeout: float | None = None, restarts: int = 1,
                   device_cast: Mapping[str, torch.dtype] | None = None):
        """Stage a host round stream for this trainer through
        ``data.prefetch.device_feed`` on the trainer's device: the host's
        round building and the copies overlap the rounds, and
        ``train_round`` takes the staged tensors as they are.  ``depth``
        defaults to ``SPARKNET_FEED_DEPTH`` when set, else
        ``harvest_lag + 1``: a [τ, global_batch, ...] round is large, and
        a lagged loop keeps that many rounds in flight.  Close the
        returned feed (context manager) after the loop."""
        from ..data.pipeline import FeedStats, feed_depth
        from ..data.prefetch import device_feed
        if depth is None:
            depth = feed_depth(max(1, self.config.harvest_lag + 1))
        self.feed_stats = stats if stats is not None else FeedStats()
        return device_feed(rounds, self.device, depth=depth,
                           stats=self.feed_stats,
                           stall_timeout=stall_timeout, restarts=restarts,
                           device_cast=device_cast)

    def _to_device(self, v) -> torch.Tensor:
        return torch.as_tensor(v).to(self.device)

    def _micro(self, batches: Mapping[str, Any], t: int,
               w: int) -> dict[str, torch.Tensor]:
        """Worker ``w``'s micro-batches of step ``t`` on the device, put
        through ``device_preprocess``: blobs [iter_size, batch, ...].
        ``batches`` holds this process's rows, its workers' in order."""
        iter_size = self.sp.iter_size
        local = w - self._local.start
        micro = {}
        for k, v in batches.items():
            b = v.shape[1] // len(self._local)
            micro[k] = self._to_device(
                v[t * iter_size:(t + 1) * iter_size,
                  local * b:(local + 1) * b])
        pre = self.config.device_preprocess
        if pre is not None:
            micro = pre(micro, self.crop_generators[w])
        return micro

    # -- the rounds ------------------------------------------------------
    def _local_sgd_round(self, batches) -> tuple[dict, list]:
        """τ local steps for each of this process's workers: each
        worker's params and mean loss, by position."""
        workers, worker_losses = {}, []
        starts = (self._starts(self._local, share=False)
                  if self._resident is not None else None)
        for w in self._local:
            params = starts[w] if starts else _copy(self.params)
            state = self.state[w]
            losses = []
            for t in range(self.config.tau):
                params, state, loss = self._local_update(
                    params, state, self.iter + t, self._micro(batches, t, w),
                    self.generators[w], self.lr_scale)
                losses.append(loss)
            self.state[w] = state
            workers[w] = params
            worker_losses.append(torch.stack(losses).mean())
        return workers, worker_losses

    def _psum_steps(self, starts: Mapping[int, Params], state, batches,
                    workers: range, *, gang: bool = False):
        """τ ``sync`` steps over ``workers`` (the JAX make_psum_step,
        :577-604): per step each worker's accumulated loss and gradients,
        their means, ``preprocess_grads`` and one update.  Every worker's
        forward starts from its position's params of the step; the blobs
        of stateful layers (BatchNorm's running statistics), and only
        those, become the mean of what the workers' forwards wrote, before
        ``preprocess_grads`` (:591-597).  Workers whose ``starts`` are one
        tree form a group: one copy of the params and of the state, one
        update (the first group updates ``state`` in place; a later group,
        a position whose copy diverged, a copy of it).  With ``gang`` the
        means run over every process's workers.  Returns each worker's
        params, the first group's state and the mean loss."""
        by_tree, group_of, trees = {}, {}, []
        for w in workers:
            key = id(starts[w])
            if key not in by_tree:
                by_tree[key] = len(trees)
                trees.append(starts[w])
            group_of[w] = by_tree[key]
        states = [state] + [
            {name: {k: [b.clone() for b in v] for k, v in tree.items()}
             for name, tree in state.items()} for _ in trees[1:]]
        losses = []
        for t in range(self.config.tau):
            it = self.iter + t
            step_losses, step_grads, step_params = [], [], []
            for w in workers:
                loss, after, grads = self._accum(
                    trees[group_of[w]], self._micro(batches, t, w),
                    self.generators[w])
                step_losses.append(loss)
                step_grads.append(grads)
                step_params.append({k: after[k] for k in self._state_keys})
            if gang:
                step_losses = self._gather_rows(step_losses)
                step_grads = self._gather_rows(step_grads)
                step_params = self._gather_rows(step_params)
            stateful = _mean(step_params) if self._state_keys else None
            grads_mean = _mean(step_grads)
            rate = learning_rate(self.sp, it) * self.lr_scale
            for g, params in enumerate(trees):
                if stateful is not None:
                    params = {**params, **(stateful if g == 0
                                           else _copy(stateful))}
                grads = preprocess_grads(self.sp, params, grads_mean,
                                         self._lr_mults, self._decay_mults)
                trees[g], states[g] = self.rule.apply(
                    params, grads, states[g], rate, it,
                    lr_mults=self._lr_mults)
            losses.append(torch.stack(step_losses).mean())
        return ({w: trees[group_of[w]] for w in workers}, states[0],
                torch.stack(losses).mean())

    def _local_hosts(self) -> range:
        c = self.n_chips
        return range(self._local.start // c, self._local.stop // c)

    def _hierarchical_round(self, batches) -> tuple[dict, list]:
        """Per host of this process, τ ``sync`` steps over its chips from
        its positions' params with the host's state: each chip's params,
        by position, and each host's mean loss."""
        finals, host_losses = {}, []
        c = self.n_chips
        for h in self._local_hosts():
            chips = range(h * c, (h + 1) * c)
            if self._resident is not None:
                starts = self._starts(chips, share=True)
            else:
                start = _copy(self.params)
                starts = {w: start for w in chips}
            out, self.state[h], loss = self._psum_steps(
                starts, self.state[h], batches, chips)
            finals.update(out)
            host_losses.append(loss)
        return finals, host_losses

    def _sync_round(self, batches) -> torch.Tensor:
        """τ ``sync`` steps over every worker; sets the params, the
        state and, with positions, each position's tree."""
        if self._resident is None:
            starts = {w: self.params for w in self._local}
        else:
            starts = self._starts(self._local, share=True)
        finals, self.state, loss = self._psum_steps(
            starts, self.state, batches, self._local,
            gang=self._procs > 1)
        self._params = finals[self._local.start]
        if self._resident is not None:
            self._reside(finals)
        return loss

    def _boundary_mean(self, finals: dict[int, Params]) -> None:
        """The τ-boundary average of ``local_sgd`` and ``hierarchical``
        on the plain exchange.  One copy: the mean of the tier's trees.
        With positions (after the gang's gather): under ``local_sgd``
        every position keeps the mean of every position's params; under
        ``hierarchical`` chip column c keeps the mean over hosts of its
        chips' params (one mean for all columns while a host's chips
        agree, as they do unless a copy rotted)."""
        if self.config.strategy == "local_sgd":
            mean = _mean([finals[w] for w in sorted(finals)])
            self.params = mean
            return
        c, n = self.n_chips, self.n_hosts
        means: dict[tuple, Params] = {}
        by_pos = {}
        for col in range(c):
            trees = [finals[h * c + col] for h in range(n)]
            key = tuple(id(t) for t in trees)
            if key not in means:
                means[key] = _mean(trees)
            for h in range(n):
                by_pos[h * c + col] = means[key]
        self._params = by_pos[0]
        if self._resident is not None:
            self._reside({w: by_pos[w] for w in self._local})

    def _sync_device(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _encode(self, local: Params, ref: Params, residual: Params
                ) -> tuple[Params, Params]:
        """Encode each tier's ``local - ref + residual`` (``local`` and
        ``residual`` stacked on the tier axis); returns the payload and
        the new residual, the exact f32 quantization error (the JAX
        package's ``enc``, trainer.py:772-776)."""
        delta = {k: [x - r.unsqueeze(0) + e for x, r, e in
                     zip(local[k], ref[k], residual[k])] for k in ref}
        payload, _, new_residual = comms.roundtrip_tree(self._codec, delta)
        return payload, new_residual

    def _decode(self, payload: Params, ref: Params) -> Params:
        """``ref`` plus the tier mean of the decoded deltas (the JAX
        package's ``dec``, trainer.py:778-781)."""
        deltas = comms.decode_tree(self._codec, payload)
        return {k: [r + d.mean(0) for r, d in zip(ref[k], deltas[k])]
                for k in ref}

    def _tier_rows(self) -> range:
        """This process's rows of the stacked per-tier state: its
        workers, or its hosts under hierarchical."""
        if self.config.strategy == "hierarchical":
            return self._local_hosts()
        return self._local

    def _exchange(self, local: list[Params]) -> None:
        """The compressed τ-boundary average (the JAX package's
        ``_run_comm_round``, :805-836): encode this process's tier rows,
        exchange the stacked payload (alone it passes as it is; in a gang
        the processes all-gather it, ``comms.exchange_bytes`` counting
        what the wire carries), decode every row and average.
        ``stall_s`` charges each stage's host time under both settings.
        Without ``comm_overlap`` the host also waits for the device after
        each stage, and the wait is charged with it; with it the three
        stages queue without a wait and give the same bits."""
        overlap = self.config.comm_overlap
        rows = self._tier_rows()
        whole = len(rows) == self._state_tier()
        t0 = time.perf_counter()
        residual = (self.comm_residual if whole else
                    {k: [r[rows.start:rows.stop] for r in v]
                     for k, v in self.comm_residual.items()})
        payload, residual = self._encode(_stack(local), self.params,
                                         residual)
        if whole:
            self.comm_residual = residual
        else:
            for k, v in self.comm_residual.items():
                for r, new in zip(v, residual[k]):
                    r[rows.start:rows.stop] = new
        if not overlap:
            self._sync_device()
        self.stall_s["comm_encode"] += time.perf_counter() - t0
        t0 = time.perf_counter()
        gathered = payload
        if not whole:
            leaves = [t for blobs in payload.values() for p in blobs
                      for t in comms._leaves(p)]
            parts = cluster.all_gather_tensors(leaves)
            joined = iter([torch.cat(ts) for ts in zip(*parts)])

            def rebuild(p):
                if isinstance(p, torch.Tensor):
                    return next(joined)
                return type(p)(rebuild(q) for q in p)
            gathered = {k: [rebuild(p) for p in blobs]
                        for k, blobs in payload.items()}
        if not overlap:
            self._sync_device()
        self.stall_s["comm_allreduce"] += time.perf_counter() - t0
        t0 = time.perf_counter()
        self.params = self._decode(gathered, self.params)
        if not overlap:
            self._sync_device()
        self.stall_s["comm_decode"] += time.perf_counter() - t0

    def train_round(self, batches: Mapping[str, Any]) -> float:
        """Run one round.  ``batches`` maps each input blob to an array or
        tensor of shape [τ·iter_size, N·batch, ...] (tensors already on
        the device are used as they are): worker w takes rows
        w·batch:(w+1)·batch of every minibatch, and step t the minibatches
        t·iter_size:(t+1)·iter_size.  Returns the round's loss, the mean
        over workers and steps.  When the solver's ``snapshot`` interval
        was crossed, writes ``<snapshot_prefix>_iter_<iter>.npz``; every
        ``checkpoint_every`` rounds, a round checkpoint.

        With ``guard_numerics`` a rejected round is dropped: the trainer
        rolls back and ``self.round`` does not move, so a ``while
        trainer.round < rounds`` loop replays it (the poisoned loss is
        still returned).  With ``harvest_lag`` K > 0 the return value is
        the loss of the round K back (``nan`` until there is one; every
        harvested loss lands in ``round_losses``), and a trip found then
        rolls back and drops the rounds in flight after it.  Call
        ``drain()`` before reading the final params."""
        with telemetry.span("trainer.round", cat="trainer",
                            round=self.round):
            loss_val = self._train_round_impl(batches)
        self._publish_round()
        return loss_val

    def _publish_round(self) -> None:
        """The per-round counter, gauges and throttled snapshot: host
        numbers only, never a device read."""
        self._m_rounds.inc()
        self._m_pending.set(len(self._pending))
        for k, v in self.stall_s.items():
            self._m_stall.set(v, comp=k)
        telemetry.get_registry().maybe_snapshot()

    def _train_round_impl(self, batches: Mapping[str, Any]) -> float:
        from ..utils import faults
        expect = self.batches_per_round
        for k, v in batches.items():
            if v.shape[0] != expect:
                raise ValueError(f"{k}: leading dim {v.shape[0]} != "
                                 f"tau*iter_size {expect}")
            if v.shape[1] % len(self._local):
                raise ValueError(f"{k}: batch {v.shape[1]} not divisible by "
                                 f"{len(self._local)} local workers")
        round_idx = self.round
        lag = self.config.harvest_lag
        from . import health
        health.maybe_beat(round_idx, "round_start")
        injector = faults.get_injector()
        # a flipped bit in one position's resident copy between rounds
        # (the event the audit exists to catch before the next average
        # folds it in)
        flip = injector.bitflip_rank(round_idx)
        if flip is not None:
            print(f"FAULT: bitflip_params corrupting replica {flip}'s "
                  f"params at round {round_idx}", file=sys.stderr,
                  flush=True)
            self._inject_bitflip(flip)
        audit_fps = None
        if (self.config.audit_every
                and round_idx % self.config.audit_every == 0):
            if lag:
                # over the params the round starts from, read with the
                # round's loss
                audit_fps = self._fingerprints()
            else:
                t0 = time.perf_counter()
                fps = self.audit_params()
                self.stall_s["audit_fetch"] += time.perf_counter() - t0
                if not self._audit_ok(fps):
                    # the round is dropped before it runs; self.round
                    # rewinds to the rollback point and the loop replays
                    self._audit_trip(round_idx, fps)
                    return float("nan")
                self._last_audit_ok = round_idx
        if injector.nan_inject(round_idx):
            print(f"FAULT: nan_inject poisoning round {round_idx} feed",
                  file=sys.stderr, flush=True)
            batches = {k: _poison(v) for k, v in batches.items()}
        t0 = time.perf_counter()
        with full_f32():
            if self.config.strategy == "sync":
                loss = self._sync_round(batches)
                self.worker_params = []
            else:
                if self.config.strategy == "hierarchical":
                    finals, losses = self._hierarchical_round(batches)
                    rows = [finals[h * self.n_chips]
                            for h in self._local_hosts()]
                    self.worker_params = []
                else:
                    finals, losses = self._local_sgd_round(batches)
                    rows = [finals[w] for w in self._local]
                loss = torch.stack(self._gather_rows(losses)).mean()
                if self._codec is None:
                    if self._procs > 1:
                        finals = dict(zip(range(self.n_workers),
                                          self._gather_rows(
                                              [finals[w]
                                               for w in self._local])))
                    if self.config.strategy == "local_sgd":
                        self.worker_params = [finals[w]
                                              for w in sorted(finals)]
                    self._boundary_mean(finals)
                else:
                    if self.config.strategy == "local_sgd":
                        self.worker_params = rows
                    self._exchange(rows)
                del finals, rows
        if lag:
            finite = (self._finite(self.params)
                      if self.config.guard_numerics else None)
            self._pending.append({"round": round_idx, "loss": loss,
                                  "finite": finite, "fps": audit_fps})
            loss_val = float("nan")
        else:
            t1 = time.perf_counter()
            loss_val = float(loss)
            self.stall_s["loss_fetch"] += time.perf_counter() - t1
            if self.config.guard_numerics:
                reason = self._poison_reason(loss_val)
                if reason:
                    self.round_seconds[round_idx] = time.perf_counter() - t0
                    self._guard_trip(round_idx, reason)
                    return loss_val   # round dropped; self.round unchanged
                self._loss_history = (self._loss_history + [loss_val])[-8:]
            self.round_losses[round_idx] = loss_val
        self.round_seconds[round_idx] = time.perf_counter() - t0
        prev = self.iter
        self.iter += self.config.tau
        # snapshot on schedule at round granularity (Solver::Step checks
        # every iteration, reference: solver.cpp:270-277; the JAX trainer
        # fires when a round crossed the interval, trainer.py:1012-1017)
        if (self.sp.snapshot and self.sp.snapshot_prefix
                and prev // self.sp.snapshot != self.iter // self.sp.snapshot):
            self.snapshot(f"{self.sp.snapshot_prefix}_iter_{self.iter}.npz")
        self.round += 1
        if (self.config.checkpoint_dir
                and self.round % self.config.checkpoint_every == 0):
            self.save_round_checkpoint()
        health.maybe_beat(round_idx, "round_end", extras=self._beat_extras())
        while len(self._pending) > lag:
            h = self._harvest_one()
            if h is not None:
                loss_val = h
        return loss_val

    def _beat_extras(self) -> dict:
        """Telemetry riding the round_end heartbeat: per-component host
        stalls, trip counters and the feed's stats, under the JAX
        trainer's keys (the fleet status view reads them)."""
        extras = {
            "stall_s": {k: round(v, 4) for k, v in self.stall_s.items()},
            "guard_trips": self.guard_trips,
            "audit_trips": self.audit_trips,
        }
        if self.feed_stats is not None:
            extras["feed"] = self.feed_stats.snapshot()
        return extras

    # -- the numerical guard (the JAX package's trainer.py:1048-1130) -----
    @staticmethod
    def _finite(tree: Params) -> torch.Tensor:
        """One 0-d bool tensor: every float leaf of ``tree`` finite."""
        flags = [torch.isfinite(x).all() for blobs in tree.values()
                 for x in blobs if x.is_floating_point()]
        if not flags:
            return torch.tensor(True)
        return torch.stack(flags).all()

    def _loss_poison_reason(self, loss_val: float) -> str | None:
        """A non-finite loss, or one over ``loss_spike_factor`` times the
        trailing mean of the last (at most 8, at least 3) losses."""
        if not np.isfinite(loss_val):
            return f"non-finite loss {loss_val}"
        factor = self.config.loss_spike_factor
        if factor > 0 and len(self._loss_history) >= 3:
            mean = sum(self._loss_history) / len(self._loss_history)
            if loss_val > factor * mean:
                return (f"loss spike {loss_val:.4g} > {factor:g} x "
                        f"trailing mean {mean:.4g}")
        return None

    def _poison_reason(self, loss_val: float) -> str | None:
        """Why the round just run should be rejected, or None."""
        reason = self._loss_poison_reason(loss_val)
        if reason:
            return reason
        t0 = time.perf_counter()
        finite = bool(self._finite(self.params))
        self.stall_s["finite_check"] += time.perf_counter() - t0
        if not finite:
            return "non-finite parameters after averaging"
        return None

    def _guard_trip(self, round_idx: int, reason: str) -> None:
        """Reject round ``round_idx``: roll back to the newest valid
        checkpoint at or before it (params, state, residuals, iter, round
        and generators, so the replay is exact), back off the rate, and
        count the trip."""
        self.guard_trips += 1
        self._m_guard.inc()
        rec = telemetry.get_recorder()
        rec.record("guard_trip", round=round_idx, reason=reason,
                   trips=self.guard_trips)
        rec.dump("guard_trip")
        print(f"guard: round {round_idx} REJECTED ({reason}); rolling "
              f"back to last valid checkpoint at round <= {round_idx} "
              f"(trip {self.guard_trips}/{self.config.guard_max_trips})",
              file=sys.stderr, flush=True)
        if self.guard_trips > self.config.guard_max_trips:
            raise TrainingDivergedError(
                f"numerical guard tripped {self.guard_trips} times "
                f"(> guard_max_trips={self.config.guard_max_trips}); "
                f"last reason: {reason}")
        manifest = self.resume_latest(self.config.checkpoint_dir,
                                      max_round=round_idx)
        if manifest is None:
            raise TrainingDivergedError(
                f"round {round_idx} poisoned ({reason}) and no valid "
                f"checkpoint at round <= {round_idx} to roll back to in "
                f"{self.config.checkpoint_dir!r}")
        if self.config.guard_lr_backoff != 1.0:
            self.lr_scale *= self.config.guard_lr_backoff
            print(f"guard: LR scale backed off to {self.lr_scale:g}",
                  file=sys.stderr, flush=True)

    # -- the cross-replica audit (the JAX package's :1231-1395) -----------
    def _fingerprints(self):
        """Every position's fingerprint of its resident tree: an int64
        tensor [n_pos] (or [n_pos, 2] under a plan: the replicated
        leaves, the resident tile), each the sum of its leaves' uint32
        bit patterns mod 2**32.  This process's positions are summed on
        the device; a gang gathers the others'."""
        self._ensure_resident()
        plan = self.shard_plan
        zero = torch.zeros((), dtype=torch.int64, device=self.device)
        rows = []
        for w in self._local:
            rep, tile = zero, zero
            for name, blobs in self._resident[w].items():
                for i, leaf in enumerate(blobs):
                    s = _leaf_bits(leaf)
                    if s is None:
                        continue
                    if plan is None or plan.dim_of(f"{name}/{i}") is None:
                        rep = rep + s
                    else:
                        tile = tile + s
            rows.append(rep if plan is None else torch.stack([rep, tile]))
        fps = torch.stack(self._gather_rows(rows)) & 0xFFFFFFFF
        return fps

    def audit_params(self) -> np.ndarray:
        """Per-position parameter fingerprints, uint32: one a position,
        or [replicated, tile] a position under a plan.  A healthy layout
        gives one value (one a tile group), the JAX trainer's exactly."""
        return self._fps_host(self._fingerprints())

    @staticmethod
    def _fps_host(fps) -> np.ndarray:
        if isinstance(fps, torch.Tensor):
            fps = fps.cpu().numpy()
        return np.asarray(fps).astype(np.uint32)

    def _audit_groups(self) -> list[list[int]]:
        """Positions that hold the same tile: a chip column across hosts
        under hierarchical, each position alone on a flat layout (whose
        tile column can then only trip the replicated column)."""
        if self.config.strategy == "hierarchical":
            return [[h * self.n_chips + c for h in range(self.n_hosts)]
                    for c in range(self.n_chips)]
        return [[i] for i in range(self.n_workers)]

    def _audit_culprits(self, fps: np.ndarray) -> list[int]:
        """Positions whose fingerprints disagree with their group's
        majority: 1-D fps against the whole layout; 2-D fps column 0
        layout-wide, column 1 within each tile group."""
        fps = np.asarray(fps)
        if fps.ndim == 1:
            checks = [(list(range(fps.shape[0])), fps)]
        else:
            checks = [(list(range(fps.shape[0])), fps[:, 0])]
            checks += [(g, fps[:, 1]) for g in self._audit_groups()]
        culprits: set[int] = set()
        for group, col in checks:
            sel = col[group]
            vals, counts = np.unique(sel, return_counts=True)
            if vals.size <= 1:
                continue
            majority = vals[int(np.argmax(counts))]
            culprits.update(g for g, f in zip(group, sel) if f != majority)
        return sorted(culprits)

    def _audit_ok(self, fps) -> bool:
        return not self._audit_culprits(self._fps_host(fps))

    def _audit_trip(self, round_idx: int, fps) -> None:
        """A position's params diverged: roll back to the newest
        checkpoint at or before the last audit that passed, the guard's
        rollback with its generator replay."""
        self.audit_trips += 1
        self.guard_trips += 1
        fps = self._fps_host(fps)
        culprits = self._audit_culprits(fps)
        fps_hex = [hex(int(f)) for f in fps.reshape(-1)]
        self._m_audit.inc()
        rec = telemetry.get_recorder()
        rec.record("audit_mismatch", round=round_idx, culprits=culprits,
                   fingerprints=fps_hex, last_ok=self._last_audit_ok)
        rec.dump("audit_mismatch")
        print(f"audit: round {round_idx} REJECTED — cross-replica param "
              f"fingerprints diverge (replicas {culprits} vs the "
              f"majority: {fps_hex}); rolling back to "
              f"a round <= {self._last_audit_ok} checkpoint "
              f"(trip {self.guard_trips}/{self.config.guard_max_trips})",
              file=sys.stderr, flush=True)
        if self.guard_trips > self.config.guard_max_trips:
            raise TrainingDivergedError(
                f"audit tripped at round {round_idx} and the trip budget "
                f"is spent ({self.guard_trips} > guard_max_trips="
                f"{self.config.guard_max_trips}); replicas {culprits} "
                f"keep diverging")
        manifest = self.resume_latest(self.config.checkpoint_dir,
                                      max_round=self._last_audit_ok)
        if manifest is None:
            raise TrainingDivergedError(
                f"round {round_idx}: replicas {culprits} diverged and no "
                f"checkpoint at round <= {self._last_audit_ok} remains "
                f"in {self.config.checkpoint_dir!r}")

    def _inject_bitflip(self, replica: int) -> None:
        """``bitflip_params@rank:R``: flip bit 22 of the first element of
        position R's copy of the first non-empty f32 leaf, in sorted
        layer order (its tile, where the plan shards that leaf).  The
        value stays finite, so only the audit sees it.  In a gang only
        the process that holds R flips it."""
        self._ensure_resident()
        w = replica % self.n_workers
        if w not in self._resident:
            return
        for name in sorted(self._params):
            blobs = self._params[name]
            if blobs and blobs[0].numel() and blobs[0].dtype == torch.float32:
                break
        else:
            return
        own = self._resident[w][name]
        leaf = own[0].detach().clone()
        flat = leaf.view(-1).view(torch.int32)
        flat[0] = flat[0] ^ (1 << 22)
        own[0] = leaf

    # -- the harvest lag (the JAX package's trainer.py:1132-1229) ---------
    def _harvest_one(self) -> float | None:
        with telemetry.span("trainer.harvest", cat="trainer",
                            round=int(self._pending[0]["round"])):
            return self._harvest_one_impl()

    def _harvest_one_impl(self) -> float | None:
        """Read the oldest round in flight: its audit verdict, its loss,
        then its finite verdict.  A trip drops every younger round in
        flight, flushes the writer, rolls back and removes the
        checkpoints newer than the rollback.  Returns the loss (a
        poisoned one too), or None when the audit dropped the round
        before it counted."""
        e = self._pending.popleft()
        round_idx = int(e["round"])
        if e["fps"] is not None:
            # the audit looked at the params the round started from: its
            # verdict comes first
            t0 = time.perf_counter()
            fps = self._fps_host(e["fps"])
            self.stall_s["audit_fetch"] += time.perf_counter() - t0
            if not self._audit_ok(fps):
                self._pending.clear()
                self.flush_checkpoints()
                self._audit_trip(round_idx, fps)
                self._drop_checkpoints_after(self.round)
                return None
            self._last_audit_ok = round_idx
        t0 = time.perf_counter()
        loss_val = float(e["loss"])
        self.stall_s["loss_fetch"] += time.perf_counter() - t0
        if self.config.guard_numerics:
            reason = self._loss_poison_reason(loss_val)
            if reason is None and e["finite"] is not None:
                t0 = time.perf_counter()
                finite = bool(e["finite"])
                self.stall_s["finite_check"] += time.perf_counter() - t0
                if not finite:
                    reason = "non-finite parameters after averaging"
            if reason:
                self._pending.clear()
                self.flush_checkpoints()
                self._guard_trip(round_idx, reason)
                self._drop_checkpoints_after(self.round)
                return loss_val
            self._loss_history = (self._loss_history + [loss_val])[-8:]
        self.round_losses[round_idx] = loss_val
        return loss_val

    def drain(self) -> dict[int, float]:
        """Harvest every round in flight and flush the checkpoint writer;
        returns ``round_losses``.  A verdict read here can trip and
        rewind ``self.round``: a loop that wants the dropped rounds
        replayed runs ``while trainer.round < rounds`` around it."""
        while self._pending:
            self._harvest_one()
        self.flush_checkpoints()
        return dict(self.round_losses)

    def flush_checkpoints(self) -> None:
        """Wait for this trainer's queued checkpoint writes; raises a
        background write's error.  A no-op on the synchronous path."""
        if self._ckpt_writer is not None:
            t0 = time.perf_counter()
            try:
                self._ckpt_writer.flush()
            finally:
                self.stall_s["checkpoint"] += time.perf_counter() - t0

    def _drop_checkpoints_after(self, round_idx: int) -> None:
        """Remove the checkpoints newer than ``round_idx``: after a
        lagged trip rolled back, those written during the lag descend
        from the poisoned round."""
        directory = self.config.checkpoint_dir
        if not directory or self._rank != 0:
            return
        for mpath in glob.glob(os.path.join(directory, "manifest_*.json")):
            r = _manifest_round(mpath)
            if r > round_idx:
                # the glob sweeps a sharded checkpoint's tiles too
                for p in (mpath, *glob.glob(os.path.join(
                        directory, f"ckpt_round_{r:08d}*.npz"))):
                    try:
                        os.remove(p)
                    except OSError:
                        pass

    def test(self, feed: Iterator[Mapping[str, Any]],
             num_steps: int) -> dict[str, Any]:
        """Distributed eval (reference: ImageNetApp.scala:108-141): each
        worker scores ITS rows of every test batch with the master params;
        scalar outputs are summed over worker-batches, batched outputs
        over rows too.  An optional ``"__valid__"`` (local workers,) 0/1
        mask drops exhausted workers' padding rows.
        ``"__test_batches__"`` counts the worker-batches scored, so
        ``totals[k] / totals["__test_batches__"]`` is the reference's
        normalization.  In a gang each process feeds its own rows and
        the scores of every worker are summed in worker order, step by
        step, in every process (the JAX trainer's psum, :1427-1445)."""
        n_local = len(self._local)
        scored: list = []
        with torch.inference_mode(), full_f32():
            for step in range(num_steps):
                raw = dict(next(feed))
                valid = np.asarray(raw.pop("__valid__", np.ones(n_local)))
                if valid.shape != (n_local,):
                    raise ValueError(
                        f"__valid__ must have shape ({n_local},), got "
                        f"{valid.shape}")
                for j, w in enumerate(self._local):
                    if not valid[j]:
                        continue
                    batch = {}
                    for k, v in raw.items():
                        b = v.shape[0] // n_local
                        batch[k] = self._to_device(v[j * b:(j + 1) * b])
                    out = self.test_net.forward(self.params, batch,
                                                train=False)
                    vals = {}
                    for k, val in out.blobs.items():
                        val = val.float()
                        val = (val.sum(0) if val.dim() else val).cpu()
                        vals[k] = (float(val) if val.dim() == 0
                                   else val.numpy())
                    scored.append((step, w, vals))
        if self._procs > 1:
            scored = sorted((rec for part in cluster.all_gather_objects(
                scored) for rec in part), key=lambda r: (r[0], r[1]))
        totals: dict[str, Any] = {"__test_batches__": 0.0}
        for _, _, vals in scored:
            for k, val in vals.items():
                totals[k] = totals.get(k, 0.0) + val
            totals["__test_batches__"] += 1.0
        return totals

    # -- snapshots (the JAX package's layout, trainer.py:1494-1638) -------
    def _host_blob(self) -> dict[str, Any]:
        """The full training state in the JAX package's checkpoint
        layout: ``params``; ``state``, stacked on a leading tier axis
        (workers under ``local_sgd``, hosts under ``hierarchical``) and
        unstacked under ``sync``; ``iter``, ``round``, ``strategy``,
        ``n_workers``, ``lr_scale``; ``n_hosts`` under hierarchical;
        ``comm_residual`` and ``comm_codec`` with a codec;
        ``shard_plan`` (the plan's id) under a plan, whose params are the
        full logical leaves all the same.  Leaves are
        tensors where they live (``save_checkpoint`` and
        ``snapshot_tree`` copy them out); the stacked state is a fresh
        stack, so it aliases nothing.  The port's generator states go
        under ``torch_generators`` (the JAX package ignores that key; the
        port ignores the JAX package's ``rng``, a ``jax.random`` key)."""
        states, residual = self.state, self.comm_residual
        gens = [[g.get_state(), c.get_state()]
                for g, c in zip(self.generators, self.crop_generators)]
        if self._procs > 1:
            # a collective: each tier's rows from the process that owns
            # them
            rows = self._tier_rows()
            if self.config.strategy != "sync":
                states = self._gather_rows([self.state[t] for t in rows])
            gens = self._gather_rows([gens[w] for w in self._local])
            if residual is not None:
                residual = {k: [torch.cat(self._gather_rows(
                    [r[rows.start:rows.stop]])) for r in v]
                    for k, v in residual.items()}
        if self.config.strategy == "sync":
            state = states
        else:
            state = {name: {k: [torch.stack([s[name][k][i]
                                             for s in states])
                                for i in range(len(blobs))]
                            for k, blobs in tree.items()}
                     for name, tree in states[0].items()}
        blob = {
            "params": self.params,
            "state": state,
            "iter": self.iter,
            "round": self.round,
            "strategy": self.config.strategy,
            "n_workers": self.n_workers,
            "lr_scale": np.float64(self.lr_scale),
            "torch_generators": {"dropout": [g for g, _ in gens],
                                 "crop": [c for _, c in gens]},
        }
        if self.shard_plan is not None:
            blob["shard_plan"] = self.shard_plan_id
        if self.config.strategy == "hierarchical":
            blob["n_hosts"] = self.n_hosts
        if residual is not None:
            blob["comm_residual"] = residual
            blob["comm_codec"] = self.config.comm_codec
        return blob

    def _apply_blob(self, blob: Mapping[str, Any]) -> None:
        """Restore a blob of ``_host_blob``'s layout, written by either
        package.  Refuses another strategy, and another worker (or host)
        count unless ``elastic``, which re-tiers the stacked state and
        residuals (new row i from saved row i mod saved_n)."""
        saved_strategy = str(np.asarray(blob.get("strategy", "")))
        if saved_strategy and saved_strategy != self.config.strategy:
            raise ValueError(
                f"checkpoint strategy {saved_strategy!r} != trainer "
                f"{self.config.strategy!r} (per-worker optimizer state is "
                f"not convertible)")
        elastic = self.config.elastic
        state = blob["state"]
        saved_workers = int(blob["n_workers"]) if "n_workers" in blob \
            else None
        if saved_workers is not None and saved_workers != self.n_workers:
            if not elastic:
                raise ValueError(
                    f"checkpoint has {saved_workers} workers, the trainer "
                    f"has {self.n_workers} (set TrainerConfig.elastic=True "
                    f"to re-form on a different worker set)")
            print(f"elastic: re-forming {saved_workers} -> "
                  f"{self.n_workers} workers (params are the consensus "
                  f"average; stacked optimizer state re-tiled)",
                  file=sys.stderr, flush=True)
        n_tier = self._state_tier()
        if self.config.strategy == "hierarchical" and "n_hosts" in blob \
                and int(blob["n_hosts"]) != self.n_hosts and not elastic:
            raise ValueError(
                f"checkpoint has {int(blob['n_hosts'])} hosts, the trainer "
                f"has {self.n_hosts} (per-host optimizer state does not "
                f"re-tile; set TrainerConfig.elastic=True)")

        def dev(a) -> torch.Tensor:
            return torch.from_numpy(np.array(a)).to(self.device)

        params = {k: [dev(b) for b in blob["params"][k]]
                  for k in self.params}
        if self.config.strategy == "sync":
            new_state = {name: {k: [dev(b) for b in tree[k]]
                                for k in self.params}
                         for name, tree in state.items()}
        else:
            rows = {name: {k: [_retier(b, n_tier) for b in tree[k]]
                           for k in self.params}
                    for name, tree in state.items()}
            new_state = [{name: {k: [dev(b[i]) for b in tree[k]]
                                 for k in self.params}
                          for name, tree in rows.items()}
                         for i in range(n_tier)]
        if self.comm_residual is not None:
            saved_codec = str(np.asarray(blob.get("comm_codec", "")))
            if "comm_residual" in blob and saved_codec == \
                    self.config.comm_codec:
                res = blob["comm_residual"]
                self.comm_residual = {
                    k: [dev(_retier(b, n_tier)) for b in res[k]]
                    for k in self.params}
            else:
                # a checkpoint without residuals, or of another codec:
                # they mean nothing on this wire format, so error
                # feedback starts afresh
                if saved_codec:
                    print(f"resume: checkpoint residuals are for codec "
                          f"{saved_codec!r}, trainer runs "
                          f"{self.config.comm_codec!r}: resetting error "
                          f"feedback", file=sys.stderr, flush=True)
                self.comm_residual = self._zero_residual()
        self.params, self.state = params, new_state
        self.worker_params = []
        self.iter = int(blob["iter"])
        if "round" in blob:
            self.round = int(blob["round"])
        if "lr_scale" in blob:
            self.lr_scale = float(np.asarray(blob["lr_scale"]))
        gens = blob.get("torch_generators")
        if gens is not None:
            # workers past the saved count keep their own seeding
            for g, s in zip(self.generators, gens["dropout"]):
                g.set_state(torch.from_numpy(np.array(s, np.uint8)))
            for g, s in zip(self.crop_generators, gens["crop"]):
                g.set_state(torch.from_numpy(np.array(s, np.uint8)))

    def snapshot(self, path: str) -> None:
        """Write the training state to ``path`` (npz, checksummed); in a
        gang every process calls it, process 0 writes and the others wait
        for it."""
        from ..utils.checkpoint import save_checkpoint
        blob = self._host_blob()
        if self._rank == 0:
            save_checkpoint(path, blob)
        cluster.barrier()

    def restore(self, path: str) -> None:
        """Read a snapshot written by either package.  Refuses one of
        another strategy, or of another worker count unless ``elastic``."""
        from ..utils.checkpoint import load_checkpoint
        self._apply_blob(load_checkpoint(path))

    # -- round checkpoints and resume (the JAX package's :1642-1907) ------
    def save_round_checkpoint(self, directory: str | None = None
                              ) -> str | None:
        """Write ``ckpt_round_<round>.npz`` and its manifest for the
        current round, in the JAX package's order: the npz (tmp+rename;
        with ``shard_checkpoint`` under a plan the sharded leaves as one
        ``.shardNN.npz`` tile a shard beside it), the fault hooks, the
        manifest with every file's sha256 (tmp+rename, last, behind the
        fence check), then pruning to ``checkpoint_keep`` and the sweep
        of orphan temporaries.  With the asynchronous writer the state is
        copied out without blocking and the write runs on the writer's
        thread; ``flush_checkpoints`` waits for it.  In a gang every
        process calls it (the blob is a collective), process 0 writes and
        the others wait at a barrier.  Returns the npz's path on process
        0, None elsewhere."""
        with telemetry.span("trainer.ckpt_submit", cat="ckpt",
                            round=self.round):
            return self._save_round_checkpoint_impl(directory)

    def _save_round_checkpoint_impl(self, directory: str | None) -> str:
        from ..utils import faults, knobs
        from ..utils.checkpoint import (
            AsyncCheckpointWriter, CheckpointFencedError, advance_fence,
            async_checkpoints_enabled, check_fence, save_checkpoint,
            snapshot_tree, split_sharded_tree)
        directory = directory or self.config.checkpoint_dir
        if not directory:
            raise ValueError("no checkpoint directory configured")
        # the injector of the round that schedules the write decides its
        # faults, whatever the env says when the writer gets to it
        injector = faults.get_injector()
        t0 = time.perf_counter()
        blob = self._host_blob()
        if self._rank != 0:
            cluster.barrier()
            self.stall_s["checkpoint"] += time.perf_counter() - t0
            return None
        os.makedirs(directory, exist_ok=True)
        fence_token = knobs.get_int("SPARKNET_FENCE_TOKEN", 0)
        if fence_token:
            advance_fence(directory, fence_token)
        round_now = self.round
        name = f"ckpt_round_{round_now:08d}.npz"
        path = os.path.join(directory, name)
        manifest = {
            "round": round_now,
            "iter": self.iter,
            "file": name,
            "sha256": None,   # filled in after the npz lands
            "mesh_shape": self.mesh.shape,
            "strategy": self.config.strategy,
            "n_workers": self.n_workers,
            "tau": self.config.tau,
            "data_cursor": self.data_cursor,
        }
        # the sharded layout: the tiles' files and the manifest's shards
        # and shard_dims; the manifest still appears last, so a torn
        # write of several files is no checkpoint at all
        plan = self.shard_plan
        shard_ckpt = plan is not None and self.config.shard_checkpoint
        if plan is not None:
            manifest["shard_plan"] = self.shard_plan_id
        shard_paths: list[str] = []

        def job(blob=blob) -> None:
            if not isinstance(blob, dict):
                blob = blob.wait()
            check_fence(directory, fence_token)
            if shard_ckpt:
                common, parts = split_sharded_tree(
                    blob["params"], plan.dims_dict(), plan.n_shards)
                save_checkpoint(path, {**blob, "params": common})
                entries = []
                for k, part in enumerate(parts):
                    sname = f"ckpt_round_{round_now:08d}.shard{k:02d}.npz"
                    spath = os.path.join(directory, sname)
                    save_checkpoint(spath, part)
                    shard_paths.append(spath)
                    entries.append({"file": sname,
                                    "sha256": _sha256_file(spath)})
                manifest["shards"] = entries
                manifest["shard_dims"] = plan.dims_dict()
            else:
                save_checkpoint(path, blob)
            # the torn-write window: the npz is durable, the manifest is
            # not yet; crash_in_ckpt dies here
            injector.on_checkpoint_write(round_now)
            corrupt = injector.corrupt_checkpoint(round_now)
            manifest["sha256"] = _sha256_file(path)
            manifest["fence_token"] = fence_token
            mpath = os.path.join(directory,
                                 f"manifest_{round_now:08d}.json")
            tmp = f"{mpath}.tmp.{os.getpid()}"
            with open(tmp, "w") as f:
                json.dump(manifest, f, indent=1)
            # the last gate before the checkpoint becomes visible
            try:
                check_fence(directory, fence_token)
            except CheckpointFencedError:
                for p in (tmp, path, *shard_paths):
                    try:
                        os.remove(p)
                    except OSError:
                        pass
                raise
            os.replace(tmp, mpath)
            if corrupt:
                print(f"FAULT: corrupt_ckpt scribbling {path}",
                      file=sys.stderr, flush=True)
                faults.scribble(path)
            self._prune_checkpoints(directory)

        if self.config.async_checkpoint and async_checkpoints_enabled():
            snap = snapshot_tree(blob)
            if self._ckpt_writer is None:
                self._ckpt_writer = AsyncCheckpointWriter()
            self._ckpt_writer.submit(lambda: job(snap))
        else:
            job()
        cluster.barrier()
        self.stall_s["checkpoint"] += time.perf_counter() - t0
        return path

    def _prune_checkpoints(self, directory: str) -> None:
        keep = max(int(self.config.checkpoint_keep), 1)
        rounds = sorted(
            (_manifest_round(m) for m in
             glob.glob(os.path.join(directory, "manifest_*.json"))),
            reverse=True)
        for r in rounds[keep:]:
            # the glob sweeps a sharded checkpoint's tiles too
            for p in (os.path.join(directory, f"manifest_{r:08d}.json"),
                      *glob.glob(os.path.join(
                          directory, f"ckpt_round_{r:08d}*.npz"))):
                try:
                    os.remove(p)
                except OSError:
                    pass
        # temporaries of writers killed mid-write.  This process's own
        # may be in flight: the main thread claims the fence of the next
        # round (FENCE.json.tmp.<pid>) while this writer thread prunes
        own = f".tmp.{os.getpid()}"
        for p in glob.glob(os.path.join(directory, "*.tmp.*")):
            if p.endswith(own):
                continue
            try:
                os.remove(p)
            except OSError:
                pass

    def resume_latest(self, directory: str,
                      max_round: int | None = None) -> dict[str, Any] | None:
        """Restore from the newest manifest (at most ``max_round``) whose
        checkpoint validates: the file's sha256 against the manifest,
        then the content checksum inside.  A corrupt or partial one is
        skipped with a message naming it; a checkpoint of another
        strategy or layout raises (a config error, not corruption)
        unless ``elastic`` allows the layout.  Returns the manifest
        resumed from, or None when there is no valid checkpoint."""
        from ..utils import knobs
        from ..utils.checkpoint import (CheckpointError, advance_fence,
                                        flush_all_writers, join_sharded_tree,
                                        load_checkpoint)
        # the newest manifest must not be sitting in a writer's queue,
        # process 0's in a gang
        flush_all_writers()
        cluster.barrier()
        fence_token = knobs.get_int("SPARKNET_FENCE_TOKEN", 0)
        if fence_token and os.path.isdir(directory):
            advance_fence(directory, fence_token)
        for mpath in sorted(
                glob.glob(os.path.join(directory, "manifest_*.json")),
                key=_manifest_round, reverse=True):
            if max_round is not None and _manifest_round(mpath) > max_round:
                continue
            try:
                with open(mpath) as f:
                    manifest = json.load(f)
                path = os.path.join(directory, manifest["file"])
                got = _sha256_file(path)
                if got != manifest["sha256"]:
                    raise CheckpointError(
                        f"manifest sha256 mismatch (manifest "
                        f"{manifest['sha256'][:12]}…, file {got[:12]}…)",
                        path)
                blob = load_checkpoint(path)
                entries = manifest.get("shards") or []
                if entries:
                    # every tile against the manifest, then the full
                    # leaves: a bad tile fails the whole checkpoint
                    parts = []
                    for e in entries:
                        spath = os.path.join(directory, e["file"])
                        sgot = _sha256_file(spath)
                        if sgot != e["sha256"]:
                            raise CheckpointError(
                                f"shard sha256 mismatch (manifest "
                                f"{e['sha256'][:12]}…, file {sgot[:12]}…)",
                                spath)
                        parts.append(load_checkpoint(spath))
                    blob["params"] = join_sharded_tree(
                        blob["params"], parts,
                        manifest.get("shard_dims") or {})
            except (OSError, json.JSONDecodeError, KeyError, TypeError,
                    CheckpointError) as e:
                print(f"resume: skipping {os.path.basename(mpath)}: {e}",
                      file=sys.stderr, flush=True)
                continue
            mesh_shape = manifest.get("mesh_shape")
            if mesh_shape and mesh_shape != self.mesh.shape:
                if not self.config.elastic:
                    raise ValueError(
                        f"checkpoint mesh shape {mesh_shape} != trainer "
                        f"mesh {self.mesh.shape} (set TrainerConfig."
                        f"elastic=True to re-form on a different mesh)")
                print(f"elastic: resuming checkpoint of mesh {mesh_shape} "
                      f"on mesh {self.mesh.shape}", file=sys.stderr,
                      flush=True)
            self._apply_blob(blob)
            self.round = int(manifest.get("round", self.round))
            self.data_cursor = manifest.get("data_cursor")
            # the restore gives every position the same params
            self._last_audit_ok = self.round
            telemetry.get_recorder().record(
                "resume", round=self.round, iter=self.iter,
                file=os.path.basename(manifest["file"]))
            print(f"resume: restored round {self.round} (iter {self.iter}) "
                  f"from {os.path.basename(manifest['file'])}",
                  file=sys.stderr, flush=True)
            return manifest
        return None
