"""The port's quantizers (``ops/quant.py``) and codecs
(``parallel/comms.py``) against the JAX package's, on the CPU.

- Every quantizer equals the JAX package's bit for bit on the same f32
  arrays (``q``, the scales and the bf16 wire bits), run op by op as its
  own tests run it.  Per-tensor, per-row
  and per-(row, channel) scales, all-zero tensors and channels, ties at
  .5 (both round half to even), values at ±amax, and subnormal elements
  in a group whose scale is normal.
- Groups made only of subnormals are held against an IEEE numpy model
  instead: the JAX package's CPU backend flushes subnormals to zero (as
  the TPU has none), where torch and the card keep them (ROADMAP C).
- ``roundtrip_tree``: ``decoded + residual == delta`` exactly for every
  codec that keeps its residual; a planted codec with
  ``keep_residual=False`` breaks it.  Its payload equals the JAX
  package's bit for bit.
- ``exchange_bytes`` equals the JAX package's for each codec on lenet at
  n_tier 4 (bf16 3,448,640, int8 1,724,448) and on every zoo net at
  n_tier 2, from the JAX package's own function on its own shapes.
- The registry's errors, and ``comm_config_from_env`` against the JAX
  package's on the same environment.

Tolerance: zero everywhere (bit equality), except the decoded int8
values of the error-feedback accumulation test, which hold within one
quantization step as the JAX test states it (tests/test_comms.py:160).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sparknet_tpu import models as jax_models
from sparknet_tpu.graph.net import Net as JaxNet
from sparknet_tpu.ops import quant as jquant
from sparknet_tpu.parallel import TrainerConfig as JaxConfig
from sparknet_tpu.parallel import comm_config_from_env as jax_from_env
from sparknet_tpu.parallel import comms as jcomms
from sparknet_tpu.proto import NetState as JaxNetState
from sparknet_tpu.proto import Phase as JaxPhase
from sparknet_tpu_torch import models
from sparknet_tpu_torch.graph.net import Net
from sparknet_tpu_torch.ops import quant
from sparknet_tpu_torch.parallel import TrainerConfig, comm_config_from_env
from sparknet_tpu_torch.parallel import comms
from sparknet_tpu_torch.proto import NetState, Phase
from torch_threads import one_torch_thread  # noqa: F401 (fixture)

FLT_MIN = np.finfo(np.float32).tiny
KEEPS = [(), (0,), (0, 1)]


def _case(name: str) -> np.ndarray:
    """The named [4, 8, 3, 5] f32 input, from seed 0."""
    rng = np.random.default_rng(0)
    x = rng.normal(size=(4, 8, 3, 5)).astype(np.float32)
    if name == "normal":
        return x
    if name == "tiny":          # scales near the bottom of f32's range
        return (x * np.float32(1e-30)).astype(np.float32)
    if name == "huge":
        return (x * np.float32(1e30)).astype(np.float32)
    if name == "zeros":
        return np.zeros_like(x)
    if name == "zero_rows_and_channels":
        x[1] = 0.0
        x[2, 3] = 0.0
        x[0, :, 1] = 0.0
        return x
    if name == "ties":
        # every (row, channel) group has amax 127 (scale exactly 1) and
        # the other values sit on .5: round half to even decides them
        k = rng.integers(-126, 126, size=x.shape)
        x = (k + 0.5).astype(np.float32)
        x[:, :, 0, 0] = 127.0
        x[:, :, 0, 1] = -127.0
        return x
    if name == "at_amax":
        x[..., 0, 0] = np.abs(x).max(axis=(2, 3))
        x[..., 0, 1] = -np.abs(x).max(axis=(2, 3))
        return x
    if name == "subnormal_elements":
        # subnormals beside normal values: every scale stays normal
        mask = rng.random(size=x.shape) < 0.5
        sub = (rng.normal(size=x.shape) * 1e-39).astype(np.float32)
        return np.where(mask, sub, x).astype(np.float32)
    raise KeyError(name)


CASES = ["normal", "tiny", "huge", "zeros", "zero_rows_and_channels",
         "ties", "at_amax", "subnormal_elements"]


@pytest.mark.parametrize("keep", KEEPS, ids=["tensor", "row", "channel"])
@pytest.mark.parametrize("case", CASES)
def test_quantize_int8_equals_jax(case, keep):
    x = _case(case)
    jq, js = jquant.quantize_int8(x, keep)
    q, s = quant.quantize_int8(torch.from_numpy(x), keep)
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    assert s.numpy().tobytes() == np.asarray(js).tobytes()
    assert s.shape == np.asarray(js).shape
    deq = quant.dequantize_int8(q, s).numpy()
    assert deq.tobytes() == np.asarray(
        jquant.dequantize_int8(jq, js)).tobytes()


@pytest.mark.parametrize("case", CASES)
def test_quantize_bf16_equals_jax(case):
    x = _case(case)
    got = quant.quantize_bf16(torch.from_numpy(x))
    want = np.asarray(jquant.quantize_bf16(x))
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.view(torch.int16).numpy(),
                                  want.view(np.int16))
    back = quant.dequantize_bf16(got).numpy()
    assert back.tobytes() == np.asarray(
        jquant.dequantize_bf16(want)).tobytes()


def test_bf16_subnormals_and_specials_equal_jax():
    x = np.array([1e-40, -3e-39, 1.4e-45, FLT_MIN, np.inf, -np.inf, 0.0,
                  -0.0, 3.3895314e38], np.float32)
    got = quant.quantize_bf16(torch.from_numpy(x)).view(torch.int16).numpy()
    np.testing.assert_array_equal(
        got, np.asarray(jquant.quantize_bf16(x)).view(np.int16))


def test_compiled_jax_rewrites_the_arithmetic():
    """Inside a compiled program (the JAX trainer's encode) XLA's CPU
    compiler turns ``amax / 127`` into ``amax * f32(1/127)`` and
    contracts ``delta - q·s`` into one fused multiply-add, so there the
    JAX package's scale can move by an ulp and ``decoded + residual``
    miss ``delta``.  The port keeps the arithmetic as written (ROADMAP
    C): equal to the op-by-op JAX, its invariant exact."""
    amax = np.array([0.00115158, 9.0675330e-06 * 127], np.float32)
    x = np.stack([amax, -amax / 3])
    _, compiled = jax.jit(lambda x: jquant.quantize_int8(x, (1,)))(x)
    _, ours = quant.quantize_int8(torch.from_numpy(x), (1,))
    assert np.asarray(compiled).tobytes() == \
        (amax * np.float32(1 / 127)).tobytes()
    assert ours.numpy().tobytes() == (amax / np.float32(127)).tobytes()
    assert ours.numpy().tobytes() != np.asarray(compiled).tobytes()
    delta = _delta_tree()
    codec = jcomms.get_codec("int8")
    _, jdec, jres = jax.jit(lambda t: jcomms.roundtrip_tree(codec, t))(
        {k: [jnp.asarray(b) for b in v] for k, v in delta.items()})
    _, dec, res = comms.roundtrip_tree(comms.get_codec("int8"),
                                       _torch_tree(delta))
    got = np.asarray(jdec["conv"][0]) + np.asarray(jres["conv"][0])
    assert not np.array_equal(got, delta["conv"][0])
    assert np.array_equal((dec["conv"][0] + res["conv"][0]).numpy(),
                          delta["conv"][0])


def test_round_is_half_to_even_in_both():
    halves = np.array([-2.5, -1.5, -0.5, 0.5, 1.5, 2.5, 125.5], np.float32)
    want = np.array([-2, -2, -0, 0, 2, 2, 126], np.float32)
    np.testing.assert_array_equal(torch.round(torch.from_numpy(halves))
                                  .numpy(), want)
    np.testing.assert_array_equal(np.asarray(jnp.round(halves)), want)


def _ieee_int8(x: np.ndarray, keep) -> tuple[np.ndarray, np.ndarray]:
    """The quantizer in numpy's IEEE arithmetic (subnormals kept)."""
    axes = tuple(i for i in range(x.ndim) if i not in keep)
    amax = np.abs(x).max(axis=axes, keepdims=True) if axes else np.abs(x)
    s = np.where(amax > 0, amax / np.float32(127), np.float32(1.0))
    q = np.clip(np.round(x / s), -127, 127).astype(np.int8)
    return q, s.astype(np.float32)


@pytest.mark.parametrize("keep", KEEPS, ids=["tensor", "row", "channel"])
def test_all_subnormal_groups_follow_ieee(keep):
    """A group of subnormals only: the port keeps them (as the card does)
    and quantizes onto a subnormal scale; the JAX CPU backend flushes
    them, so it is not the oracle here."""
    x = (np.random.default_rng(3).normal(size=(4, 8, 3, 5)) * 1e-39) \
        .astype(np.float32)
    q, s = quant.quantize_int8(torch.from_numpy(x), keep)
    wq, ws = _ieee_int8(x, keep)
    np.testing.assert_array_equal(q.numpy(), wq)
    assert s.numpy().tobytes() == ws.tobytes()
    assert np.abs(q.numpy()).max() == 127


def _delta_tree(scale=1e-3):
    """tests/test_comms.py's delta tree."""
    rng = np.random.default_rng(7)
    return {"conv": [rng.normal(scale=scale, size=(4, 8, 1, 5, 5))
                     .astype(np.float32)],
            "bias": [rng.normal(scale=scale / 10, size=(4, 8))
                     .astype(np.float32)]}


def _torch_tree(tree):
    return {k: [torch.from_numpy(np.array(b)) for b in v]
            for k, v in tree.items()}


def _flat(payload) -> list[np.ndarray]:
    if isinstance(payload, torch.Tensor):
        return [payload.view(torch.int16).numpy()
                if payload.dtype == torch.bfloat16 else payload.numpy()]
    if isinstance(payload, (list, tuple)):
        return [a for p in payload for a in _flat(p)]
    if isinstance(payload, dict):
        return [a for k in sorted(payload) for a in _flat(payload[k])]
    a = np.asarray(payload)
    return [a.view(np.int16) if a.dtype == jnp.bfloat16 else a]


@pytest.mark.parametrize("name", ["none", "bf16", "int8", "int8_channel"])
def test_roundtrip_equals_jax_and_keeps_the_invariant(name):
    delta = _delta_tree()
    payload, decoded, residual = comms.roundtrip_tree(
        comms.get_codec(name), _torch_tree(delta))
    jpayload, jdecoded, jresidual = jcomms.roundtrip_tree(
        jcomms.get_codec(name), {k: [jnp.asarray(b) for b in v]
                                 for k, v in delta.items()})
    for a, b in zip(_flat(payload), _flat(jpayload)):
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes()
    for k in delta:
        assert residual[k][0].numpy().tobytes() == \
            np.asarray(jresidual[k][0]).tobytes()
        assert decoded[k][0].numpy().tobytes() == \
            np.asarray(jdecoded[k][0]).tobytes()
        # the error-feedback invariant, exact
        assert (decoded[k][0] + residual[k][0]).numpy().tobytes() == \
            delta[k][0].tobytes()


def test_residual_dropper_breaks_the_invariant():
    int8 = comms.get_codec("int8")
    dropres = comms.Codec("int8_dropres_t", encode=int8.encode,
                          decode=int8.decode, keep_residual=False)
    delta = _torch_tree(_delta_tree())
    _, decoded, residual = comms.roundtrip_tree(dropres, delta)
    assert all(not r.any() for v in residual.values() for r in v)
    assert any(not torch.equal(decoded[k][0] + residual[k][0], delta[k][0])
               for k in delta)


def test_error_feedback_accumulation_stays_bounded():
    """The same delta fed 32 times with the residual carried forward: the
    decoded total stays within one quantization step of 32 x delta."""
    codec = comms.get_codec("int8")
    delta = {"w": [torch.full((8, 8), 3.7e-4)]}
    res = {"w": [torch.zeros(8, 8)]}
    total = torch.zeros(8, 8)
    for _ in range(32):
        fed = {"w": [delta["w"][0] + res["w"][0]]}
        _, decoded, res = comms.roundtrip_tree(codec, fed)
        total = total + decoded["w"][0]
    step = 3.7e-4 / quant.INT8_LEVELS
    assert float((total - 32 * 3.7e-4).abs().max()) <= step + 1e-7


def _jax_shapes(net_param) -> dict:
    net = JaxNet(net_param, JaxNetState(JaxPhase.TRAIN))
    return jax.eval_shape(net.init, jax.random.PRNGKey(0))


def _torch_shapes(net_param) -> dict:
    net = Net(net_param, NetState(Phase.TRAIN))
    return {k: [torch.empty(s, device="meta") for s in v]
            for k, v in net.param_shapes().items()}


@pytest.mark.parametrize("name", ["none", "bf16", "int8", "int8_channel"])
def test_exchange_bytes_lenet_n4_equals_jax(name):
    got = comms.exchange_bytes(comms.get_codec(name),
                               _torch_shapes(models.lenet(64, 64)), 4)
    want = jcomms.exchange_bytes(jcomms.get_codec(name),
                                 _jax_shapes(jax_models.lenet(64, 64)), 4)
    assert got == want
    assert got == {"bf16": 3_448_640, "int8": 1_724_448}.get(name, got)


ZOO = ["lenet", "cifar10_quick", "cifar10_full", "alexnet", "caffenet",
       "googlenet", "vgg16"]


@pytest.mark.parametrize("model", ZOO)
def test_exchange_bytes_every_zoo_net_n2_equals_jax(model):
    port_net = getattr(models, model)(1, 1)
    jax_net = getattr(jax_models, model)(1, 1)
    ours = _torch_shapes(port_net)
    theirs = _jax_shapes(jax_net)
    for name in comms.codec_names():
        assert comms.exchange_bytes(comms.get_codec(name), ours, 2) == \
            jcomms.exchange_bytes(jcomms.get_codec(name), theirs, 2), name


def test_exchange_bytes_come_from_the_encode():
    """A codec registered here is counted by what its encode returns."""
    codec = comms.Codec("halves_t", encode=lambda x: x[:, ::2].to(
        torch.float16), decode=lambda p: p.float())
    params = {"w": [torch.empty(6, 3, device="meta")]}
    assert comms.exchange_bytes(codec, params, 2) == 2 * 3 * 3 * 2


def test_registry_errors():
    assert comms.codec_names() == ("bf16", "int8", "int8_channel", "none")
    with pytest.raises(ValueError, match="unknown comm codec"):
        comms.get_codec("int4")
    with pytest.raises(ValueError, match="already registered"):
        comms.register_codec(comms.Codec("int8", encode=lambda x: x,
                                         decode=lambda x: x))
    c = comms.register_codec(comms.Codec("plant_t", encode=lambda x: x,
                                         decode=lambda x: x))
    try:
        assert comms.get_codec("plant_t") is c
        comms.register_codec(comms.Codec("plant_t", encode=lambda x: x,
                                         decode=lambda x: x,
                                         keep_residual=False),
                             allow_replace=True)
        assert not comms.get_codec("plant_t").keep_residual
    finally:
        comms._CODECS.pop("plant_t")


@pytest.mark.parametrize("env", [
    {}, {"SPARKNET_TAU": "7"}, {"SPARKNET_COMM_CODEC": "int8"},
    {"SPARKNET_TAU": "7", "SPARKNET_COMM_CODEC": "int8_channel",
     "SPARKNET_COMM_OVERLAP": "1"},
    {"SPARKNET_COMM_OVERLAP": "0"}, {"SPARKNET_TAU": "0"}],
    ids=["unset", "tau", "codec", "all", "overlap_off", "tau_zero"])
def test_comm_config_from_env_equals_jax(monkeypatch, env):
    for k in ("SPARKNET_TAU", "SPARKNET_COMM_CODEC",
              "SPARKNET_COMM_OVERLAP", "SPARKNET_SHARD",
              "SPARKNET_SHARD_CKPT"):
        monkeypatch.delenv(k, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    base = dict(strategy="local_sgd", tau=2, comm_overlap=True)
    ours = comm_config_from_env(TrainerConfig(**base))
    theirs = jax_from_env(JaxConfig(**base))
    for f in ("strategy", "tau", "comm_codec", "comm_overlap"):
        assert getattr(ours, f) == getattr(theirs, f), f
    if not env:
        assert ours == TrainerConfig(**base)


def test_comm_config_from_env_refuses_the_shard_knobs(monkeypatch):
    monkeypatch.setenv("SPARKNET_SHARD", "auto")
    with pytest.raises(NotImplementedError, match="A12"):
        comm_config_from_env()
