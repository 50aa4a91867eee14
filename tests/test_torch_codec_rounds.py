"""Compressed τ-boundary exchange in the port's rounds against the JAX
trainer's, on the CPU.

``local_sgd`` (4 workers) and ``hierarchical`` (2 hosts x 2 chips) with
each lossy codec, on lenet at tests/test_comms.py's rate (base_lr 0.005),
from the same weights on the same rounds:

- **Encode, bit for bit.**  The JAX trainer's encode is wrapped to keep
  its inputs (each tier's local params, the reference params, the
  residual) and outputs.  The port's ``_encode`` on those very inputs
  gives the payload and the new residual of the JAX package's encode
  arithmetic (``l - r + e``, ``comms.roundtrip_tree``) bit for bit.
  Against the JAX trainer's compiled program, where XLA's CPU compiler
  multiplies by f32(1/127) and contracts the residual into a fused
  multiply-add (ROADMAP C): the int8 and bf16 wire values are equal, a
  scale is at most one ulp off, and a residual at most ``RES_ULPS`` = 4
  ulps of its decoded value.
- **Trajectories.**  A 1e-7 difference in a delta can push one element
  across a rounding boundary and move it by one quantization step, and
  error feedback carries that step into the next round.  So after each
  of 3 rounds the losses agree at rtol 2e-4 and every param element
  either agrees at tests/test_torch_trainer.py's rtol 2e-4, atol 2e-5 or
  differs by at most one step of its row's scale (int8: the tier row's
  scale, the largest of the tiers; int8_channel: the row's channel's;
  bf16: the spacing of bf16 at the row's largest decoded delta), and at
  most ``MAX_STEPPED`` = 20 elements of lenet's 431,080 per round may
  use that allowance.
- ``comm_overlap`` is bit-identical to no overlap, and both charge
  each stage's host time to ``stall_s``, as the JAX trainer does
  (ROADMAP C, F4); only the run without it also waits for the device.
- ``comm_codec="none"`` never enters ``comms`` and is today's round bit
  for bit; a lossy codec converges near full precision
  (tests/test_comms.py:247-258's bound); residuals are per host under
  ``hierarchical``.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sparknet_tpu.models import lenet as jax_lenet
from sparknet_tpu.parallel import DistributedTrainer as JaxTrainer
from sparknet_tpu.parallel import TrainerConfig as JaxConfig
from sparknet_tpu.parallel import comms as jcomms
from sparknet_tpu.parallel import make_mesh as jax_mesh
from sparknet_tpu.parallel import make_pod_mesh as jax_pod_mesh
from sparknet_tpu.proto import load_solver_prototxt_with_net as jax_solver
from sparknet_tpu_torch.convert import params_from_jax
from sparknet_tpu_torch.models import lenet
from sparknet_tpu_torch.parallel import (DistributedTrainer, TrainerConfig,
                                         comms, make_mesh, make_pod_mesh)
from sparknet_tpu_torch.proto import load_solver_prototxt_with_net
from test_torch_trainer import _lenet_rounds
from torch_threads import one_torch_thread  # noqa: F401 (fixture)

RTOL, ATOL = 2e-4, 2e-5
MAX_STEPPED = 20
RES_ULPS = 4
SOLVER_TXT = 'base_lr: 0.005\nmomentum: 0.9\nlr_policy: "fixed"\n'
LOSSY = ["bf16", "int8", "int8_channel"]
STRATEGIES = ["local_sgd", "hierarchical"]


def _sp():
    return load_solver_prototxt_with_net(SOLVER_TXT, lenet(4, 4))


def _layout(strategy):
    return make_pod_mesh(2, 2) if strategy == "hierarchical" \
        else make_mesh(4)


def _trainer(strategy, codec="none", **kw):
    return DistributedTrainer(_sp(), _layout(strategy),
                              TrainerConfig(strategy=strategy, tau=2,
                                            comm_codec=codec, **kw),
                              device="cpu")


def _pair(strategy, codec):
    mesh = jax_pod_mesh(2, 2) if strategy == "hierarchical" \
        else jax_mesh(4)
    jtr = JaxTrainer(jax_solver(SOLVER_TXT, jax_lenet(4, 4)), mesh,
                     JaxConfig(strategy=strategy, tau=2, comm_codec=codec),
                     seed=0)
    tr = _trainer(strategy, codec)
    tr.params = params_from_jax(jax.device_get(jtr.params), tr.train_net,
                                device="cpu")
    return jtr, tr


def _rounds(n):
    return _lenet_rounds(20, rounds=n, steps=2, global_batch=16)


def _np(tree):
    return {k: [np.array(b) for b in v] for k, v in tree.items()}


def _tensors(tree):
    return {k: [torch.from_numpy(b) for b in v] for k, v in tree.items()}


def _flat_payload(p) -> list[np.ndarray]:
    if isinstance(p, torch.Tensor):
        return [p.view(torch.int16).numpy() if p.dtype == torch.bfloat16
                else p.numpy()]
    if isinstance(p, (list, tuple)):
        return [a for x in p for a in _flat_payload(x)]
    a = np.asarray(p)
    return [a.view(np.int16) if str(a.dtype) == "bfloat16" else a]


@pytest.mark.parametrize("codec", LOSSY)
@pytest.mark.parametrize("strategy", STRATEGIES)
def test_encode_of_the_jax_locals_is_bit_identical(strategy, codec):
    jtr, tr = _pair(strategy, codec)
    encode, exchange, decode = jtr._comm
    seen = []

    def spy(local, ref, residual):
        inputs = (_np(jax.device_get(local)), _np(jax.device_get(ref)),
                  _np(jax.device_get(residual)))
        payload, new_res = encode(local, ref, residual)
        seen.append((inputs, jax.device_get(payload),
                     _np(jax.device_get(new_res))))
        return payload, new_res

    jtr._comm = (spy, exchange, decode)
    for batches in _rounds(2):
        jtr.train_round(batches)
    assert len(seen) == 2
    jcodec = jcomms.get_codec(codec)
    for (local, ref, residual), cpayload, cres in seen:
        assert local["conv1"][0].shape[0] == (2 if strategy ==
                                              "hierarchical" else 4)
        payload, new_res = tr._encode(_tensors(local), _tensors(ref),
                                      _tensors(residual))
        # the JAX package's encode arithmetic, op by op
        delta = {k: [jnp.asarray(x) - jnp.asarray(r)[None] + jnp.asarray(e)
                     for x, r, e in zip(local[k], ref[k], residual[k])]
                 for k in ref}
        jpayload, _, jres = jcomms.roundtrip_tree(jcodec, delta)
        for k in ref:
            for i in range(len(ref[k])):
                ours = _flat_payload(payload[k][i])
                for a, b in zip(ours, _flat_payload(jpayload[k][i])):
                    assert a.tobytes() == b.tobytes(), f"{k}[{i}] payload"
                assert new_res[k][i].numpy().tobytes() == \
                    np.asarray(jres[k][i]).tobytes(), f"{k}[{i}] residual"
                # the compiled program: same wire values, scales within
                # an ulp, residuals within RES_ULPS of the decoded value
                theirs = _flat_payload(cpayload[k][i])
                assert ours[0].tobytes() == theirs[0].tobytes()
                dec = comms.get_codec(codec).decode(payload[k][i]).numpy()
                if codec != "bf16":
                    s_ours, s_theirs = ours[1], theirs[1]
                    assert np.all(np.abs(s_ours - s_theirs)
                                  <= np.spacing(s_ours))
                gap = np.abs(new_res[k][i].numpy() - cres[k][i])
                assert np.all(gap <= RES_ULPS * np.spacing(np.abs(dec))), \
                    f"{k}[{i}] residual vs the compiled encode"


def _steps(codec, payload) -> dict:
    """Per element, one quantization step of its row: the largest over
    the tier rows."""
    out = {}
    for k, blobs in payload.items():
        row = []
        for p in blobs:
            if codec == "bf16":
                dec = comms.get_codec("bf16").decode(p).abs()
                row.append(dec.amax(0) * 2.0 ** -7)
            else:
                row.append(p[1].amax(0))
        out[k] = row
    return out


@pytest.mark.parametrize("codec", LOSSY)
@pytest.mark.parametrize("strategy", STRATEGIES)
def test_codec_rounds_track_jax_within_one_step(strategy, codec):
    jtr, tr = _pair(strategy, codec)
    seen = {}
    encode = tr._encode

    def spy(local, ref, residual):
        payload, new_res = encode(local, ref, residual)
        seen["payload"] = payload
        return payload, new_res

    tr._encode = spy
    for r, batches in enumerate(_rounds(3)):
        jloss = jtr.train_round(batches)
        loss = tr.train_round(batches)
        np.testing.assert_allclose(loss, jloss, rtol=RTOL,
                                   err_msg=f"round {r} loss")
        want = jax.device_get(jtr.params)
        steps = _steps(codec, seen["payload"])
        stepped = 0
        for k, blobs in tr.params.items():
            for i, b in enumerate(blobs):
                w = np.asarray(want[k][i])
                diff = np.abs(b.numpy() - w)
                out = diff > ATOL + RTOL * np.abs(w)
                step = np.broadcast_to(steps[k][i].numpy(), w.shape)
                assert np.all(diff[out] <= step[out] + ATOL), \
                    f"round {r} {k}[{i}]: more than one step off"
                stepped += int(out.sum())
        assert stepped <= MAX_STEPPED, f"round {r}: {stepped} elements"


def test_overlap_is_bit_identical_and_charges_no_stall():
    rounds = _rounds(3)
    runs = {}
    for overlap in (False, True):
        tr = _trainer("local_sgd", "int8", comm_overlap=overlap)
        runs[overlap] = ([tr.train_round(b) for b in rounds], tr)
    (la, a), (lb, b) = runs[False], runs[True]
    assert la == lb
    for k, blobs in a.params.items():
        for i, x in enumerate(blobs):
            assert torch.equal(x, b.params[k][i])
            assert torch.equal(a.comm_residual[k][i], b.comm_residual[k][i])
    assert all(a.stall_s[k] > 0 for k in ("comm_encode", "comm_decode"))
    # overlap leaves out the device waits, not the stages' host time
    assert all(b.stall_s[k] > 0 for k in ("comm_encode", "comm_decode"))


def test_overlap_charges_the_comm_stall_as_the_jax_trainer_does():
    """F4: under ``comm_overlap=True`` both packages charge the encode,
    exchange and decode stages' host time (JAX trainer.py:819-835), and
    the port's int8 round is bit for bit the one without overlap."""
    rounds = _rounds(2)
    parts = ("comm_encode", "comm_allreduce", "comm_decode")
    stalls, finals = {}, {}
    for overlap in (False, True):
        jtr = JaxTrainer(jax_solver(SOLVER_TXT, jax_lenet(4, 4)),
                         jax_mesh(4),
                         JaxConfig(strategy="local_sgd", tau=2,
                                   comm_codec="int8",
                                   comm_overlap=overlap), seed=0)
        tr = _trainer("local_sgd", "int8", comm_overlap=overlap)
        losses = []
        for b in rounds:
            jtr.train_round(b)
            losses.append(tr.train_round(b))
        jax.block_until_ready(jtr.params)
        stalls[overlap] = ({k: jtr.stall_s[k] for k in parts},
                           {k: tr.stall_s[k] for k in parts})
        finals[overlap] = (losses, tr.params)
    for jax_stall, port_stall in stalls.values():
        assert sum(jax_stall.values()) > 0, jax_stall
        assert sum(port_stall.values()) > 0, port_stall
        assert port_stall["comm_encode"] > 0 and port_stall["comm_decode"] > 0
    (la, a), (lb, b) = finals[False], finals[True]
    assert la == lb
    for k, blobs in a.items():
        for i, x in enumerate(blobs):
            assert torch.equal(x, b[k][i])


def test_codec_none_is_todays_round_and_stays_off_comms(monkeypatch):
    rounds = _rounds(2)
    base = _trainer("local_sgd")
    base_losses = [base.train_round(b) for b in rounds]

    def refuse(*a, **k):
        raise AssertionError("codec none entered the exchange machinery")

    monkeypatch.setattr(comms, "roundtrip_tree", refuse)
    monkeypatch.setattr(comms, "decode_tree", refuse)
    tr = _trainer("local_sgd", "none", comm_overlap=True)
    assert tr.comm_residual is None
    assert [tr.train_round(b) for b in rounds] == base_losses
    for k, blobs in tr.params.items():
        for i, x in enumerate(blobs):
            assert torch.equal(x, base.params[k][i])
            assert torch.equal(x, torch.stack(
                [p[k][i] for p in tr.worker_params]).mean(0))


@pytest.mark.parametrize("codec", LOSSY)
def test_lossy_codec_converges_near_full_precision(codec):
    from test_comms import _batch
    full, comp = _trainer("local_sgd"), _trainer("local_sgd", codec)
    lf = [full.train_round(_batch(r)) for r in range(5)]
    lc = [comp.train_round(_batch(r)) for r in range(5)]
    assert np.isfinite(lc).all()
    assert lc[-1] < lc[0]
    assert abs(lc[-1] - lf[-1]) < 0.1


def test_hierarchical_residuals_are_per_host():
    tr = _trainer("hierarchical", "int8")
    for b in _rounds(2):
        tr.train_round(b)
    res = tr.comm_residual["conv1"][0]
    assert res.shape[0] == 2 and res.abs().max() > 0
    assert tr.stall_s["comm_encode"] > 0
