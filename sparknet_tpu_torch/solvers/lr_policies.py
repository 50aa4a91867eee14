"""Learning-rate policies, Caffe-exact.

The port's counterpart of ``sparknet_tpu/solvers/lr_policies.py``, which
mirrors ``SGDSolver::GetLearningRate`` (reference:
caffe/src/caffe/solvers/sgd_solver.cpp:27-79): fixed, step, exp, inv,
multistep, poly, sigmoid.  PyTorch runs eagerly, so the rate is a Python
float computed on the host for each step.
"""

from __future__ import annotations

import math

from ..proto.caffe_pb import SolverParameter


def learning_rate(sp: SolverParameter, it: int) -> float:
    """Rate at iteration ``it``."""
    base = sp.base_lr
    policy = sp.lr_policy
    if policy == "fixed":
        return base
    if policy == "step":
        return base * sp.gamma ** math.floor(it / sp.stepsize)
    if policy == "exp":
        return base * sp.gamma ** it
    if policy == "inv":
        return base * (1.0 + sp.gamma * it) ** -sp.power
    if policy == "multistep":
        return base * sp.gamma ** sum(it >= v for v in sp.stepvalue)
    if policy == "poly":
        return base * (1.0 - it / max(sp.max_iter, 1)) ** sp.power
    if policy == "sigmoid":
        # 1 / (1 + e^z) as 0.5 (1 - tanh(z / 2)): no overflow at large z
        z = -sp.gamma * (it - sp.stepsize)
        return base * 0.5 * (1.0 - math.tanh(0.5 * z))
    raise ValueError(f"unknown lr_policy {policy!r}")
