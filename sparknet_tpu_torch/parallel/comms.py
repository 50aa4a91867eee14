"""Compressed weight-delta exchange for the τ-boundary average.

The port's counterpart of ``sparknet_tpu/parallel/comms.py`` :1-171.
SparkNet's round exchanges full-precision weights, and on a slow link
those bytes are the round's overhead.  Each tier member (a worker under
``local_sgd``, a host under ``hierarchical``) encodes the *delta* of its
local weights against the last broadcast params with a registered codec;
the payload is exchanged, decoded and averaged the same way everywhere.

Error feedback keeps a lossy codec from losing mass over rounds: the
quantization error of round r (``delta - decode(encode(delta))``) is
kept as a per-tier residual and added into round r+1's delta before it
is encoded.  The residual is trainer state: checkpointed, rolled back
and re-tiered like the stacked solver state.

A codec is two leaf-wise functions over a stacked [n_tier, ...] f32
delta, ``encode`` (to a tensor or a tuple of tensors) and ``decode``
(back to f32), and a ``keep_residual`` flag that only a planted, broken
codec clears.  Trees are the port's params, ``{name: [tensor, ...]}``.
The quantize arithmetic lives in ``ops/quant.py``.

Codec ``none`` is registered (identity, 4 bytes a weight), but the
trainer never routes it through this module: ``comm_codec="none"`` is
the plain round.  ``sharded_exchange_bytes`` waits for the partition
plans (ROADMAP A12).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

from ..ops import quant

Tree = dict[str, list[Any]]


@dataclasses.dataclass(frozen=True)
class Codec:
    """One wire format for stacked weight deltas.  Leaves keep their
    leading tier axis through ``encode`` and ``decode``, so a scale is
    per tier row at least."""
    name: str
    encode: Callable[[torch.Tensor], Any]
    decode: Callable[[Any], torch.Tensor]
    # False: the codec drops its quantization error (no error feedback).
    # Only planted codecs do this, to prove the EF check catches them.
    keep_residual: bool = True


_CODECS: dict[str, Codec] = {}


def register_codec(codec: Codec, *, allow_replace: bool = False) -> Codec:
    if codec.name in _CODECS and not allow_replace:
        raise ValueError(f"codec {codec.name!r} already registered")
    _CODECS[codec.name] = codec
    return codec


def get_codec(name: str) -> Codec:
    try:
        return _CODECS[name]
    except KeyError:
        raise ValueError(
            f"unknown comm codec {name!r} (registered: "
            f"{sorted(_CODECS)})") from None


def codec_names() -> tuple[str, ...]:
    return tuple(sorted(_CODECS))


# -- the built-in wire formats -------------------------------------------
def _int8_keep_axes(x: torch.Tensor) -> tuple[int, ...]:
    """Per (tier, channel) scales for weight-shaped leaves, per tier row
    for stacked vectors and scalars."""
    return (0, 1) if x.dim() > 2 else (0,)


def _encode_int8(x: torch.Tensor):
    return quant.quantize_int8(x, keep_axes=(0,))


def _encode_int8_channel(x: torch.Tensor):
    return quant.quantize_int8(x, keep_axes=_int8_keep_axes(x))


def _decode_int8(payload) -> torch.Tensor:
    q, s = payload
    return quant.dequantize_int8(q, s)


register_codec(Codec("none", encode=lambda x: x.to(torch.float32),
                     decode=lambda x: x.to(torch.float32)))
register_codec(Codec("bf16", encode=quant.quantize_bf16,
                     decode=quant.dequantize_bf16))
register_codec(Codec("int8", encode=_encode_int8, decode=_decode_int8))
register_codec(Codec("int8_channel", encode=_encode_int8_channel,
                     decode=_decode_int8))


# -- tree-level operations ----------------------------------------------
def encode_tree(codec: Codec, tree: Tree) -> Tree:
    """Stacked f32 delta tree -> payload tree, leaf by leaf."""
    return {k: [codec.encode(x) for x in blobs] for k, blobs in tree.items()}


def decode_tree(codec: Codec, payload: Tree) -> Tree:
    """Payload tree -> stacked f32 delta tree."""
    return {k: [codec.decode(p) for p in blobs]
            for k, blobs in payload.items()}


def roundtrip_tree(codec: Codec, tree: Tree) -> tuple[Tree, Tree, Tree]:
    """(payload, decoded, residual) of one error-feedback step.
    ``decoded + residual == tree`` exactly in f32 for every codec that
    keeps its residual, since the residual is that difference; a codec
    with ``keep_residual=False`` returns zeros and breaks it."""
    payload = encode_tree(codec, tree)
    decoded = decode_tree(codec, payload)
    if codec.keep_residual:
        residual = {k: [d - dh for d, dh in zip(tree[k], decoded[k])]
                    for k in tree}
    else:
        residual = {k: [torch.zeros_like(d) for d in blobs]
                    for k, blobs in tree.items()}
    return payload, decoded, residual


def _leaves(payload) -> list[torch.Tensor]:
    if isinstance(payload, torch.Tensor):
        return [payload]
    if isinstance(payload, dict):
        payload = list(payload.values())
    return [t for p in payload for t in _leaves(p)]


def payload_bytes(payload) -> int:
    """Bytes of a payload tree's tensors."""
    return sum(t.numel() * t.element_size() for t in _leaves(payload))


def exchange_bytes(codec: Codec, params: Tree, n_tier: int) -> int:
    """Wire bytes of one round's exchange: the payload a [n_tier, ...]
    stacked delta of ``params`` encodes to, from the real encode run on
    meta tensors (no memory, no arithmetic), never from a formula."""
    stacked = {k: [torch.empty((n_tier,) + tuple(b.shape),
                               dtype=torch.float32, device="meta")
                   for b in blobs] for k, blobs in params.items()}
    return payload_bytes(encode_tree(codec, stacked))
