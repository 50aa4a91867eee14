"""Solver update rules: the gradient pipeline and SGD.

The port's counterpart of ``sparknet_tpu/solvers/update_rules.py`` :31-114
(reference: caffe/src/caffe/solvers/sgd_solver.cpp).  ``ApplyUpdate``'s
order is kept (sgd_solver.cpp:102-143): ClipGradients (global L2 norm of
the raw accumulated gradients) -> Normalize (/ iter_size) -> Regularize
(L2 or L1, weight_decay x decay_mult) -> the rule's update with
local_rate = rate x lr_mult.

Params, gradients and state are ``{layer: [tensor, ...]}`` dicts.  The
update writes the params and the history in place (the JAX rules are
pure): the trainer hands each worker its own copies, and in place saves
a copy of every blob per step.  Only SGD is ported; the other five rules
are queued (ROADMAP A4).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

from ..proto.caffe_pb import SolverParameter

Tree = dict[str, list[Any]]


@dataclasses.dataclass(frozen=True)
class SolverUpdate:
    """An update rule: ``init(params) -> state`` and
    ``apply(params, grads, state, rate, step, lr_mults) -> (params,
    state)``."""

    name: str
    init: Callable[[Tree], Tree]
    apply: Callable[..., tuple[Tree, Tree]]


def _tmap(f, *trees: Tree) -> Tree:
    return {k: [f(*leaves) for leaves in zip(*(t[k] for t in trees))]
            for k in trees[0]}


def _global_l2(tree: Tree) -> torch.Tensor:
    return torch.sqrt(sum(g.float().pow(2).sum()
                          for blobs in tree.values() for g in blobs))


def preprocess_grads(sp: SolverParameter, params: Tree, grads: Tree,
                     lr_mults: Tree | None, decay_mults: Tree | None
                     ) -> Tree:
    """ClipGradients -> Normalize -> Regularize (reference:
    sgd_solver.cpp:81-205).  Returns the adjusted gradients."""
    if sp.clip_gradients > 0:
        norm = _global_l2(grads)
        scale = torch.clamp(sp.clip_gradients / norm.clamp_min(1e-12),
                            max=1.0)
        grads = _tmap(lambda g: g * scale, grads)
    if sp.iter_size > 1:
        grads = _tmap(lambda g: g / sp.iter_size, grads)
    if sp.weight_decay > 0:
        dm = decay_mults if decay_mults is not None else _tmap(
            lambda g: 1.0, grads)
        if sp.regularization_type == "L2":
            grads = _tmap(lambda g, p, d: g + sp.weight_decay * d * p,
                          grads, params, dm)
        elif sp.regularization_type == "L1":
            grads = _tmap(
                lambda g, p, d: g + sp.weight_decay * d * torch.sign(p),
                grads, params, dm)
        else:
            raise ValueError(
                f"unknown regularization_type {sp.regularization_type!r}")
    return grads


def make_update_rule(sp: SolverParameter) -> SolverUpdate:
    t = sp.solver_type
    if t == "SGD":
        return _sgd(sp)
    if t in ("NESTEROV", "ADAGRAD", "RMSPROP", "ADADELTA", "ADAM"):
        raise NotImplementedError(
            f"solver type {t!r} is not ported yet (only SGD is)")
    raise ValueError(f"unknown solver type {t!r}")


def _sgd(sp: SolverParameter) -> SolverUpdate:
    """v <- momentum * v + local_rate * g;  p <- p - v
    (sgd_solver.cpp:207-244)."""

    def init(params):
        return {"history": _tmap(torch.zeros_like, params)}

    @torch.no_grad()
    def apply(params, grads, state, rate, step, lr_mults=None):
        hist = state["history"]
        for k, blobs in params.items():
            for i, p in enumerate(blobs):
                r = rate * (lr_mults[k][i] if lr_mults is not None else 1.0)
                h = hist[k][i]
                h.mul_(sp.momentum).add_(grads[k][i], alpha=r)
                p.sub_(h)
        return params, state

    return SolverUpdate("SGD", init, apply)
