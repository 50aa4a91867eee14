"""The single-step update pipeline of the trainer.

The port's counterpart of ``sparknet_tpu/solvers/step.py`` :21-88:
forward and backward -> ClipGradients -> Normalize -> Regularize -> rule
update, the ``Solver::Step`` inner body and ``ApplyUpdate`` sequence
(reference: caffe/src/caffe/solver.cpp:221-262,
solvers/sgd_solver.cpp:102-143).  Gradients come from ``torch.autograd``;
``iter_size`` micro-batches accumulate their raw gradients, which
``preprocess_grads`` then divides by ``iter_size``.
"""

from __future__ import annotations

from typing import Mapping

import torch

from ..graph.net import Net, Params
from ..proto.caffe_pb import SolverParameter
from .lr_policies import learning_rate
from .update_rules import SolverUpdate, preprocess_grads


def make_step_fns(sp: SolverParameter, net: Net, rule: SolverUpdate,
                  lr_mults, decay_mults):
    """Returns ``(loss_and_grads, local_update, accum_loss_and_grads)``,
    in the JAX package's order:

    - ``loss_and_grads(params, batch, gen) -> (loss, grads)``: one
      train-mode forward and backward; ``gen`` is the CPU generator that
      Dropout draws from;
    - ``local_update(params, state, it, batches, gen, lr_scale=1.0) ->
      (params, state, loss)``: one full solver step over ``batches``,
      whose blobs carry a leading ``iter_size`` axis; the loss is the
      micro-batches' mean, a 0-d tensor; ``lr_scale`` multiplies the
      policy's rate.  Params and state are updated in place;
    - ``accum_loss_and_grads(params, batches, gen) -> (loss, grads)``:
      the ``iter_size`` accumulation of ``Solver::Step`` (reference:
      solver.cpp:221-224), raw summed gradients (``preprocess_grads``
      divides by ``iter_size``).  ``sync`` averages these over workers
      before its one update.
    """

    def loss_and_grads(params: Params, batch: Mapping[str, torch.Tensor],
                       gen: torch.Generator | None):
        leaves = [b.detach().requires_grad_() for blobs in params.values()
                  for b in blobs]
        it = iter(leaves)
        live = {k: [next(it) for _ in blobs] for k, blobs in params.items()}
        with torch.enable_grad():
            loss = net.forward(live, batch, train=True, generator=gen).loss
            grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        it = iter(g if g is not None else torch.zeros_like(p)
                  for g, p in zip(grads, leaves))
        return loss.detach(), {k: [next(it) for _ in blobs]
                               for k, blobs in params.items()}

    def accum_loss_and_grads(params: Params,
                             batches: Mapping[str, torch.Tensor],
                             gen: torch.Generator | None):
        losses, grads = [], None
        for j in range(sp.iter_size):
            loss, g = loss_and_grads(params, {k: v[j]
                                              for k, v in batches.items()},
                                     gen)
            losses.append(loss)
            grads = g if grads is None else {
                k: [a + b for a, b in zip(grads[k], g[k])] for k in g}
        return torch.stack(losses).mean(), grads

    def local_update(params: Params, state, it: int,
                     batches: Mapping[str, torch.Tensor],
                     gen: torch.Generator | None, lr_scale: float = 1.0):
        loss, grads = accum_loss_and_grads(params, batches, gen)
        grads = preprocess_grads(sp, params, grads, lr_mults, decay_mults)
        params, state = rule.apply(params, grads, state,
                                   learning_rate(sp, it) * lr_scale, it,
                                   lr_mults=lr_mults)
        return params, state, loss

    return loss_and_grads, local_update, accum_loss_and_grads
