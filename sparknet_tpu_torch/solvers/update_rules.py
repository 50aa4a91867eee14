"""Solver update rules: the gradient pipeline and the six Caffe solvers.

The port's counterpart of ``sparknet_tpu/solvers/update_rules.py``
(reference: caffe/src/caffe/solvers/sgd_solver.cpp ComputeUpdateValue:207,
nesterov_solver.cpp, adagrad_solver.cpp, rmsprop_solver.cpp,
adadelta_solver.cpp, adam_solver.cpp).  ``ApplyUpdate``'s order is kept
(sgd_solver.cpp:102-143): ClipGradients (global L2 norm of the raw
accumulated gradients) -> Normalize (/ iter_size) -> Regularize (L2 or
L1, weight_decay x decay_mult) -> the rule's update with local_rate =
rate x lr_mult.

Params, gradients and state are ``{layer: [tensor, ...]}`` dicts.  The
update writes the params and the state in place (the JAX rules are pure):
the trainer hands each worker its own copies, and in place saves a copy
of every blob per step.  The state's slot names are the JAX package's
(``history``; AdaDelta ``sq_grad``/``sq_update``; Adam ``m``/``v``): the
npz and ``.solverstate`` layouts are keyed by them.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import numpy as np
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
    rules = {"SGD": _sgd, "NESTEROV": _nesterov, "ADAGRAD": _adagrad,
             "RMSPROP": _rmsprop, "ADADELTA": _adadelta, "ADAM": _adam}
    if sp.solver_type not in rules:
        raise ValueError(f"unknown solver type {sp.solver_type!r}")
    return rules[sp.solver_type](sp)


def _zeros(params: Tree) -> Tree:
    return _tmap(torch.zeros_like, params)


def _blobs(params: Tree, rate: float, lr_mults: Tree | None):
    """(layer, index, param, local rate) for every blob."""
    for k, blobs in params.items():
        for i, p in enumerate(blobs):
            yield k, i, p, rate * (lr_mults[k][i] if lr_mults is not None
                                   else 1.0)


def _sgd(sp: SolverParameter) -> SolverUpdate:
    """v <- momentum * v + local_rate * g;  p <- p - v
    (sgd_solver.cpp:207-244)."""

    def init(params):
        return {"history": _zeros(params)}

    @torch.no_grad()
    def apply(params, grads, state, rate, step, lr_mults=None):
        hist = state["history"]
        for k, i, p, r in _blobs(params, rate, lr_mults):
            h = hist[k][i]
            h.mul_(sp.momentum).add_(grads[k][i], alpha=r)
            p.sub_(h)
        return params, state

    return SolverUpdate("SGD", init, apply)


def _nesterov(sp: SolverParameter) -> SolverUpdate:
    """v' <- mu v + r g;  p <- p - ((1 + mu) v' - mu v)
    (nesterov_solver.cpp)."""

    def init(params):
        return {"history": _zeros(params)}

    @torch.no_grad()
    def apply(params, grads, state, rate, step, lr_mults=None):
        mu = sp.momentum
        hist = state["history"]
        for k, i, p, r in _blobs(params, rate, lr_mults):
            h = hist[k][i]
            upd = h.mul(-mu)                        # - mu v, the old v
            h.mul_(mu).add_(grads[k][i], alpha=r)
            p.sub_(upd.add_(h, alpha=1.0 + mu))
        return params, state

    return SolverUpdate("NESTEROV", init, apply)


def _adagrad(sp: SolverParameter) -> SolverUpdate:
    """h <- h + g^2;  p <- p - r g / (sqrt(h) + delta)
    (adagrad_solver.cpp)."""

    def init(params):
        return {"history": _zeros(params)}

    @torch.no_grad()
    def apply(params, grads, state, rate, step, lr_mults=None):
        hist = state["history"]
        for k, i, p, r in _blobs(params, rate, lr_mults):
            g, h = grads[k][i], hist[k][i]
            h.addcmul_(g, g)
            p.addcdiv_(g, h.sqrt().add_(sp.delta), value=-r)
        return params, state

    return SolverUpdate("ADAGRAD", init, apply)


def _rmsprop(sp: SolverParameter) -> SolverUpdate:
    """h <- rho h + (1 - rho) g^2;  p <- p - r g / (sqrt(h) + delta)
    (rmsprop_solver.cpp)."""

    def init(params):
        return {"history": _zeros(params)}

    @torch.no_grad()
    def apply(params, grads, state, rate, step, lr_mults=None):
        rd = sp.rms_decay
        hist = state["history"]
        for k, i, p, r in _blobs(params, rate, lr_mults):
            g, h = grads[k][i], hist[k][i]
            h.mul_(rd).addcmul_(g, g, value=1.0 - rd)
            p.addcdiv_(g, h.sqrt().add_(sp.delta), value=-r)
        return params, state

    return SolverUpdate("RMSPROP", init, apply)


def _adadelta(sp: SolverParameter) -> SolverUpdate:
    """g^2 and the update^2 accumulate with ``momentum`` as their decay;
    the update is g sqrt((old update^2 + delta) / (g^2 + delta)), times
    the local rate (adadelta_solver.cpp)."""

    def init(params):
        return {"sq_grad": _zeros(params), "sq_update": _zeros(params)}

    @torch.no_grad()
    def apply(params, grads, state, rate, step, lr_mults=None):
        mu = sp.momentum
        for k, i, p, r in _blobs(params, rate, lr_mults):
            g = grads[k][i]
            sq_g, sq_u = state["sq_grad"][k][i], state["sq_update"][k][i]
            sq_g.mul_(mu).addcmul_(g, g, value=1.0 - mu)
            # reads the OLD sq_update: it is rewritten only after
            upd = (sq_u + sp.delta).div_(sq_g + sp.delta).sqrt_().mul_(g)
            sq_u.mul_(mu).addcmul_(upd, upd, value=1.0 - mu)
            p.sub_(upd, alpha=r)
        return params, state

    return SolverUpdate("ADADELTA", init, apply)


def _adam(sp: SolverParameter) -> SolverUpdate:
    """m <- b1 m + (1 - b1) g;  v <- b2 v + (1 - b2) g^2;
    p <- p - r sqrt(1 - b2^t) / (1 - b1^t) m / (sqrt(v) + delta), t =
    step + 1 (adam_solver.cpp:74-113: Caffe adds delta outside the sqrt
    and puts the bias correction into the rate)."""

    def init(params):
        return {"m": _zeros(params), "v": _zeros(params)}

    @torch.no_grad()
    def apply(params, grads, state, rate, step, lr_mults=None):
        b1, b2 = sp.momentum, sp.momentum2
        # in f32, as the JAX rule computes it (and Caffe's Dtype)
        t = np.float32(step) + np.float32(1.0)
        correction = float(np.sqrt(np.float32(1.0) - np.float32(b2) ** t)
                           / (np.float32(1.0) - np.float32(b1) ** t))
        for k, i, p, r in _blobs(params, rate, lr_mults):
            g = grads[k][i]
            m, v = state["m"][k][i], state["v"][k][i]
            m.mul_(b1).add_(g, alpha=1.0 - b1)
            v.mul_(b2).addcmul_(g, g, value=1.0 - b2)
            p.addcdiv_(m, v.sqrt().add_(sp.delta), value=-r * correction)
        return params, state

    return SolverUpdate("ADAM", init, apply)
