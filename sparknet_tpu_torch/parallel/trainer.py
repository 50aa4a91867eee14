"""SparkNet's round: τ-step local SGD with weight averaging, or
synchronous SGD, over N workers on one card.

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
  state.

The round's loss is the mean over workers and steps.  On one card the N
workers run one after another, each with one CPU ``torch.Generator`` for
its Dropout masks (and, with ``device_preprocess``, one more for its crop
offsets); batching the workers (``vmap``) or running them on streams is
later work.  Every step runs in full f32 (TF32 off,
``utils.device.full_f32``), as the JAX trainer's f32 nets do on the CPU.

Rounds come from the host (numpy arrays, copied to the card per
micro-batch) or, through :meth:`DistributedTrainer.input_feed`, already
on the device, staged by ``data/prefetch.py::DeviceFeed``.
:func:`device_crop_mirror_mean` moves the random crop, the mirror and the
mean into the round (``TrainerConfig.device_preprocess``), so the host
ships raw images.  Every one of Caffe's six update rules trains here
(``solvers/update_rules.py``); ``snapshot``/``restore`` write and read the
JAX package's checkpoint layout, each rule's state slots under their JAX
names.

Not ported: the ``hierarchical`` strategy, compressed exchange codecs,
sharding, round checkpoints with resume (``checkpoint_dir``), and the
numerical guard and replica audit; asking for any of them raises.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Iterator, Mapping

import numpy as np
import torch

from ..graph.net import Net, Params
from ..proto.caffe_pb import NetState, Phase, SolverParameter
from ..solvers.lr_policies import learning_rate
from ..solvers.step import make_step_fns
from ..solvers.update_rules import make_update_rule, preprocess_grads
from ..utils.device import full_f32, resolve_device

STRATEGIES = ("local_sgd", "sync")


@dataclasses.dataclass(frozen=True)
class TrainerConfig:
    strategy: str = "local_sgd"   # "local_sgd" | "sync"
    tau: int = 1                  # steps per round
    # A callable (micro_batch_dict, generator) -> micro_batch_dict run on
    # each worker's micro-batch before its step, on the device; build one
    # with ``device_crop_mirror_mean``.
    device_preprocess: Any | None = None
    comm_codec: str = "none"
    shard: str = "off"
    checkpoint_dir: str | None = None
    guard_numerics: bool = False
    audit_every: int = 0


def _not_ported(config: TrainerConfig) -> list[str]:
    """The settings of ``config`` this port does not implement."""
    bad = []
    if config.strategy not in STRATEGIES:
        bad.append(f"strategy={config.strategy!r}")
    if config.comm_codec != "none":
        bad.append(f"comm_codec={config.comm_codec!r}")
    if config.shard != "off":
        bad.append(f"shard={config.shard!r}")
    if config.checkpoint_dir is not None:
        bad.append("checkpoint_dir")
    if config.guard_numerics:
        bad.append("guard_numerics")
    if config.audit_every:
        bad.append("audit_every")
    return bad


def _copy(params: Params) -> Params:
    return {k: [b.detach().clone() for b in v] for k, v in params.items()}


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
    one shared under ``sync``) and the round loop over ``n_workers``
    logical workers on ``device``."""

    def __init__(self, sp: SolverParameter, n_workers: int = 1,
                 config: TrainerConfig | None = None, *, seed: int = 0,
                 device: str | torch.device = "cuda"):
        self.sp = sp
        self.config = config or TrainerConfig()
        bad = _not_ported(self.config)
        if bad:
            raise NotImplementedError(
                f"not ported yet: {', '.join(bad)} (the port trains with "
                f"strategy 'local_sgd' or 'sync' only)")
        if n_workers < 1 or self.config.tau < 1:
            raise ValueError(f"n_workers and tau must be >= 1, got "
                             f"{n_workers} and {self.config.tau}")
        self.device = resolve_device(device)
        self.n_workers = n_workers
        net_param = sp.net_param or sp.train_net_param
        if net_param is None:
            raise ValueError("SolverParameter carries no net definition")
        self.train_net = Net(net_param, NetState(Phase.TRAIN))
        self.test_net = Net(net_param, NetState(Phase.TEST))
        self.rule = make_update_rule(sp)
        self.params: Params = self.train_net.init(
            torch.Generator().manual_seed(seed), device=self.device)
        self.state = self.init_state()
        self._lr_mults = self.train_net.lr_mult_tree(self.params)
        self._decay_mults = self.train_net.decay_mult_tree(self.params)
        _, self._local_update, self._accum = make_step_fns(
            sp, self.train_net, self.rule, self._lr_mults,
            self._decay_mults)
        # per worker, CPU generators whatever the device (the same draws
        # on the card and on the CPU): its Dropout masks (ops/neuron.py),
        # and its crop offsets under device_preprocess
        self.generators = [torch.Generator().manual_seed(seed * 7919 + w + 1)
                           for w in range(n_workers)]
        self.crop_generators = [
            torch.Generator().manual_seed(seed * 7919 + 104729 + w)
            for w in range(n_workers)]
        self.iter = 0
        self.round = 0
        self.lr_scale = 1.0
        self.round_losses: dict[int, float] = {}
        self.round_seconds: dict[int, float] = {}
        # each worker's params at the end of the last local_sgd round,
        # before the average: what the master params are the mean of
        # (empty under sync, where every worker holds the master params)
        self.worker_params: list[Params] = []
        # the FeedStats of the newest input_feed()
        self.feed_stats = None

    def init_state(self):
        """Fresh solver state for the current params: a list with one per
        worker under ``local_sgd``, one shared state under ``sync``."""
        if self.config.strategy == "sync":
            return self.rule.init(self.params)
        return [self.rule.init(self.params) for _ in range(self.n_workers)]

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
        defaults to ``SPARKNET_FEED_DEPTH`` when set, else 1: a [τ,
        global_batch, ...] round is large.  Close the returned feed
        (context manager) after the loop."""
        from ..data.pipeline import FeedStats, feed_depth
        from ..data.prefetch import device_feed
        if depth is None:
            depth = feed_depth(1)
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
        through ``device_preprocess``: blobs [iter_size, batch, ...]."""
        iter_size = self.sp.iter_size
        micro = {}
        for k, v in batches.items():
            b = v.shape[1] // self.n_workers
            micro[k] = self._to_device(
                v[t * iter_size:(t + 1) * iter_size, w * b:(w + 1) * b])
        pre = self.config.device_preprocess
        if pre is not None:
            micro = pre(micro, self.crop_generators[w])
        return micro

    def _local_sgd_round(self, batches) -> torch.Tensor:
        workers, worker_losses = [], []
        for w in range(self.n_workers):
            params, state = _copy(self.params), self.state[w]
            losses = []
            for t in range(self.config.tau):
                params, state, loss = self._local_update(
                    params, state, self.iter + t, self._micro(batches, t, w),
                    self.generators[w], self.lr_scale)
                losses.append(loss)
            self.state[w] = state
            workers.append(params)
            worker_losses.append(torch.stack(losses).mean())
        self.params = {k: [torch.stack([p[k][i] for p in workers]).mean(0)
                           for i in range(len(blobs))]
                       for k, blobs in workers[0].items()}
        self.worker_params = workers
        return torch.stack(worker_losses).mean()

    def _sync_round(self, batches) -> torch.Tensor:
        losses = []
        for t in range(self.config.tau):
            it = self.iter + t
            step_losses, step_grads = [], []
            for w in range(self.n_workers):
                loss, grads = self._accum(self.params,
                                          self._micro(batches, t, w),
                                          self.generators[w])
                step_losses.append(loss)
                step_grads.append(grads)
            grads = {k: [torch.stack([g[k][i] for g in step_grads]).mean(0)
                         for i in range(len(blobs))]
                     for k, blobs in step_grads[0].items()}
            grads = preprocess_grads(self.sp, self.params, grads,
                                     self._lr_mults, self._decay_mults)
            self.params, self.state = self.rule.apply(
                self.params, grads, self.state,
                learning_rate(self.sp, it) * self.lr_scale, it,
                lr_mults=self._lr_mults)
            losses.append(torch.stack(step_losses).mean())
        self.worker_params = []
        return torch.stack(losses).mean()

    def train_round(self, batches: Mapping[str, Any]) -> float:
        """Run one round.  ``batches`` maps each input blob to an array or
        tensor of shape [τ·iter_size, N·batch, ...] (tensors already on
        the device are used as they are): worker w takes rows
        w·batch:(w+1)·batch of every minibatch, and step t the minibatches
        t·iter_size:(t+1)·iter_size.  Returns the round's loss, the mean
        over workers and steps.  When the solver's ``snapshot`` interval
        was crossed, writes ``<snapshot_prefix>_iter_<iter>.npz``."""
        expect = self.batches_per_round
        for k, v in batches.items():
            if v.shape[0] != expect:
                raise ValueError(f"{k}: leading dim {v.shape[0]} != "
                                 f"tau*iter_size {expect}")
            if v.shape[1] % self.n_workers:
                raise ValueError(f"{k}: batch {v.shape[1]} not divisible by "
                                 f"{self.n_workers} workers")
        t0 = time.perf_counter()
        with full_f32():
            if self.config.strategy == "sync":
                loss = float(self._sync_round(batches))
            else:
                loss = float(self._local_sgd_round(batches))
        self.round_seconds[self.round] = time.perf_counter() - t0
        self.round_losses[self.round] = loss
        prev = self.iter
        self.iter += self.config.tau
        # snapshot on schedule at round granularity (Solver::Step checks
        # every iteration, reference: solver.cpp:270-277; the JAX trainer
        # fires when a round crossed the interval, trainer.py:1012-1017)
        if (self.sp.snapshot and self.sp.snapshot_prefix
                and prev // self.sp.snapshot != self.iter // self.sp.snapshot):
            self.snapshot(f"{self.sp.snapshot_prefix}_iter_{self.iter}.npz")
        self.round += 1
        return loss

    def test(self, feed: Iterator[Mapping[str, Any]],
             num_steps: int) -> dict[str, Any]:
        """Distributed eval (reference: ImageNetApp.scala:108-141): each
        worker scores ITS rows of every test batch with the master params;
        scalar outputs are summed over worker-batches, batched outputs
        over rows too.  An optional ``"__valid__"`` (n_workers,) 0/1 mask
        drops exhausted workers' padding rows.  ``"__test_batches__"``
        counts the worker-batches scored, so ``totals[k] /
        totals["__test_batches__"]`` is the reference's normalization."""
        totals: dict[str, Any] = {"__test_batches__": 0.0}
        with torch.inference_mode(), full_f32():
            for _ in range(num_steps):
                raw = dict(next(feed))
                valid = np.asarray(raw.pop("__valid__",
                                           np.ones(self.n_workers)))
                if valid.shape != (self.n_workers,):
                    raise ValueError(
                        f"__valid__ must have shape ({self.n_workers},), got "
                        f"{valid.shape}")
                for w in range(self.n_workers):
                    if not valid[w]:
                        continue
                    batch = {}
                    for k, v in raw.items():
                        b = v.shape[0] // self.n_workers
                        batch[k] = self._to_device(v[w * b:(w + 1) * b])
                    out = self.test_net.forward(self.params, batch,
                                                train=False)
                    for k, val in out.blobs.items():
                        val = val.float()
                        val = (val.sum(0) if val.dim() else val).cpu()
                        val = float(val) if val.dim() == 0 else val.numpy()
                        totals[k] = totals.get(k, 0.0) + val
                    totals["__test_batches__"] += 1.0
        return totals

    # -- snapshots (the JAX package's layout, trainer.py:1494-1638) -------
    def _host_blob(self) -> dict[str, Any]:
        """The full training state as host arrays, in the JAX package's
        checkpoint layout: ``params``; ``state``, stacked on a leading
        worker axis under ``local_sgd`` and unstacked under ``sync``;
        ``iter``, ``round``, ``strategy``, ``n_workers``, ``lr_scale``.
        The port's generator states go under ``torch_generators`` (the
        JAX package ignores that key; the port ignores the JAX package's
        ``rng``, a ``jax.random`` key)."""
        def host(tree):
            return {k: [b.detach().cpu().numpy() for b in v]
                    for k, v in tree.items()}

        if self.config.strategy == "sync":
            state = {name: host(tree) for name, tree in self.state.items()}
        else:
            state = {name: {k: [np.stack([s[name][k][i].detach().cpu()
                                          .numpy() for s in self.state])
                                for i in range(len(blobs))]
                            for k, blobs in tree.items()}
                     for name, tree in self.state[0].items()}
        return {
            "params": host(self.params),
            "state": state,
            "iter": self.iter,
            "round": self.round,
            "strategy": self.config.strategy,
            "n_workers": self.n_workers,
            "lr_scale": np.float64(self.lr_scale),
            "torch_generators": {
                "dropout": [g.get_state().numpy() for g in self.generators],
                "crop": [g.get_state().numpy()
                         for g in self.crop_generators]},
        }

    def _apply_blob(self, blob: Mapping[str, Any]) -> None:
        saved_strategy = str(np.asarray(blob.get("strategy", "")))
        if saved_strategy and saved_strategy != self.config.strategy:
            raise ValueError(
                f"checkpoint strategy {saved_strategy!r} != trainer "
                f"{self.config.strategy!r} (per-worker optimizer state is "
                f"not convertible)")
        if "n_workers" in blob and int(blob["n_workers"]) != self.n_workers:
            raise ValueError(
                f"checkpoint has {int(blob['n_workers'])} workers, the "
                f"trainer has {self.n_workers}")

        def dev(a) -> torch.Tensor:
            return torch.from_numpy(np.array(a)).to(self.device)

        params = {k: [dev(b) for b in blob["params"][k]]
                  for k in self.params}
        state = blob["state"]
        if self.config.strategy == "sync":
            new_state = {name: {k: [dev(b) for b in tree[k]]
                                for k in self.params}
                         for name, tree in state.items()}
        else:
            new_state = [{name: {k: [dev(np.asarray(b)[w]) for b in tree[k]]
                                 for k in self.params}
                          for name, tree in state.items()}
                         for w in range(self.n_workers)]
        self.params, self.state = params, new_state
        self.worker_params = []
        self.iter = int(blob["iter"])
        if "round" in blob:
            self.round = int(blob["round"])
        if "lr_scale" in blob:
            self.lr_scale = float(np.asarray(blob["lr_scale"]))
        gens = blob.get("torch_generators")
        if gens is not None:
            for g, s in zip(self.generators, gens["dropout"]):
                g.set_state(torch.from_numpy(np.array(s, np.uint8)))
            for g, s in zip(self.crop_generators, gens["crop"]):
                g.set_state(torch.from_numpy(np.array(s, np.uint8)))

    def snapshot(self, path: str) -> None:
        """Write the training state to ``path`` (npz, checksummed)."""
        from ..utils.checkpoint import save_checkpoint
        save_checkpoint(path, self._host_blob())

    def restore(self, path: str) -> None:
        """Read a snapshot written by either package.  Refuses one of
        another strategy or worker count."""
        from ..utils.checkpoint import load_checkpoint
        self._apply_blob(load_checkpoint(path))
