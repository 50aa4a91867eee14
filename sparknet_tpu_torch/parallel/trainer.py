"""SparkNet's τ-step local SGD with weight averaging, on one card.

The port's counterpart of ``sparknet_tpu/parallel/trainer.py``'s
``"local_sgd"`` strategy (``local_sgd_body``, :657-688; the reference's
Spark round loop, src/main/scala/apps/ImageNetApp.scala:100-182): every
one of N workers starts a round from the master params, runs τ SGD steps
on its own slice of the round's minibatches with its own solver state
(momentum history, kept across rounds), and the master params become the
mean of the workers' params.  The round's loss is the mean over workers and
steps.

On one card the N workers run one after another, each on its own copies
of the params, with one CPU ``torch.Generator`` each for its Dropout
masks.  This is the plain form of the JAX package's stacked
``[n_workers, ...]`` state; batching the workers (``vmap``) or running
them on streams is later work.  Every step runs in full f32 (TF32 off,
``utils.device.full_f32``), as the JAX trainer's f32 nets do on the CPU.

Not ported: the ``sync`` and ``hierarchical`` strategies, compressed
exchange codecs, sharding, checkpoints and resume, and the numerical
guard and replica audit; asking for any of them raises.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Iterator, Mapping

import numpy as np
import torch

from ..graph.net import Net, Params
from ..proto.caffe_pb import NetState, Phase, SolverParameter
from ..solvers.step import make_step_fns
from ..solvers.update_rules import make_update_rule
from ..utils.device import full_f32, resolve_device


@dataclasses.dataclass(frozen=True)
class TrainerConfig:
    strategy: str = "local_sgd"   # only "local_sgd" is ported
    tau: int = 1                  # local steps per round
    comm_codec: str = "none"
    shard: str = "off"
    checkpoint_dir: str | None = None
    guard_numerics: bool = False
    audit_every: int = 0


def _not_ported(config: TrainerConfig) -> list[str]:
    """The settings of ``config`` this port does not implement."""
    bad = []
    if config.strategy != "local_sgd":
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


class DistributedTrainer:
    """Master params, per-worker solver state and the round loop of
    ``local_sgd`` over ``n_workers`` logical workers on ``device``."""

    def __init__(self, sp: SolverParameter, n_workers: int = 1,
                 config: TrainerConfig | None = None, *, seed: int = 0,
                 device: str | torch.device = "cuda"):
        self.sp = sp
        self.config = config or TrainerConfig()
        bad = _not_ported(self.config)
        if bad:
            raise NotImplementedError(
                f"not ported yet: {', '.join(bad)} (the port trains with "
                f"strategy 'local_sgd' only)")
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
        self.state = [self.rule.init(self.params) for _ in range(n_workers)]
        lr_mults = self.train_net.lr_mult_tree(self.params)
        decay_mults = self.train_net.decay_mult_tree(self.params)
        _, self._local_update = make_step_fns(
            sp, self.train_net, self.rule, lr_mults, decay_mults)
        # one CPU generator per worker for its Dropout masks, drawn on the
        # CPU whatever the device (ops/neuron.py)
        self.generators = [torch.Generator().manual_seed(seed * 7919 + w + 1)
                           for w in range(n_workers)]
        self.iter = 0
        self.round = 0
        self.round_losses: dict[int, float] = {}
        self.round_seconds: dict[int, float] = {}
        # each worker's params at the end of the last round, before the
        # average: what the master params are the mean of
        self.worker_params: list[Params] = []

    @property
    def batches_per_round(self) -> int:
        """Minibatches one round consumes: τ steps x iter_size
        micro-batches (reference: solver.cpp:221-224)."""
        return self.config.tau * self.sp.iter_size

    def _to_device(self, v) -> torch.Tensor:
        return torch.as_tensor(v).to(self.device)

    def train_round(self, batches: Mapping[str, Any]) -> float:
        """Run one round.  ``batches`` maps each input blob to an array of
        shape [τ·iter_size, N·batch, ...]: worker w takes rows
        w·batch:(w+1)·batch of every minibatch, and step t the
        minibatches t·iter_size:(t+1)·iter_size.  Returns the round's
        loss, the mean over workers of each worker's mean over steps."""
        expect = self.batches_per_round
        for k, v in batches.items():
            if v.shape[0] != expect:
                raise ValueError(f"{k}: leading dim {v.shape[0]} != "
                                 f"tau*iter_size {expect}")
            if v.shape[1] % self.n_workers:
                raise ValueError(f"{k}: batch {v.shape[1]} not divisible by "
                                 f"{self.n_workers} workers")
        t0 = time.perf_counter()
        tau, iter_size = self.config.tau, self.sp.iter_size
        workers, worker_losses = [], []
        with full_f32():
            for w in range(self.n_workers):
                params, state = _copy(self.params), self.state[w]
                losses = []
                for t in range(tau):
                    micro = {}
                    for k, v in batches.items():
                        b = v.shape[1] // self.n_workers
                        micro[k] = self._to_device(
                            v[t * iter_size:(t + 1) * iter_size,
                              w * b:(w + 1) * b])
                    params, state, loss = self._local_update(
                        params, state, self.iter + t, micro,
                        self.generators[w])
                    losses.append(loss)
                self.state[w] = state
                workers.append(params)
                worker_losses.append(torch.stack(losses).mean())
            self.params = {k: [torch.stack([p[k][i] for p in workers]).mean(0)
                               for i in range(len(blobs))]
                           for k, blobs in workers[0].items()}
            loss = float(torch.stack(worker_losses).mean())
        self.worker_params = workers
        self.round_seconds[self.round] = time.perf_counter() - t0
        self.round_losses[self.round] = loss
        self.iter += tau
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
