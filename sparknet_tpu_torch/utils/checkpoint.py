"""Checkpoint files: one ``.npz`` per snapshot, with a checksum.

The port's own copy of the single-file half of
``sparknet_tpu/utils/checkpoint.py`` (``CheckpointError`` :52-58,
``_flatten``/``_unflatten``, ``content_checksum``, ``save_checkpoint``
and ``load_checkpoint``, :125-203), writing the same layout, so either
package reads the other's files.  The reference snapshots model and
solver state (reference: caffe/src/caffe/solver.cpp:447-459,
solvers/sgd_solver.cpp:242-296) and restores it in ``Solver::Restore``
(solver.cpp:510).

A checkpoint is a tree of dicts, lists and array leaves (numpy arrays,
tensors on any device, Python scalars and strings), written as an npz of
the flattened leaves plus a ``__meta__`` JSON block that records the
tree's shape and a sha256 over every leaf; nothing is pickled.  Writes
are atomic (a temporary file, then ``os.replace``); every malformed file
(truncated zip, missing arrays, bad meta, checksum mismatch) raises
:class:`CheckpointError` naming the file.  Not ported: fences, the
asynchronous writer and sharded split and join.
"""

from __future__ import annotations

import hashlib
import json
import os
import zipfile
from typing import Any

import numpy as np
import torch


class CheckpointError(Exception):
    """A checkpoint file is missing, truncated, corrupt, or fails its
    checksum.  ``path`` names the offending file."""

    def __init__(self, message: str, path: str):
        super().__init__(f"{path}: {message}")
        self.path = path


def _flatten(tree: Any, prefix: str, out: dict[str, np.ndarray],
             meta: dict[str, Any]) -> None:
    if isinstance(tree, dict):
        meta[prefix] = {"kind": "dict", "keys": sorted(tree.keys())}
        for k in sorted(tree.keys()):
            _flatten(tree[k], f"{prefix}/{k}", out, meta)
    elif isinstance(tree, (list, tuple)):
        meta[prefix] = {"kind": "list", "len": len(tree)}
        for i, v in enumerate(tree):
            _flatten(v, f"{prefix}/{i}", out, meta)
    else:
        meta[prefix] = {"kind": "leaf"}
        if isinstance(tree, torch.Tensor):
            tree = tree.detach().cpu().numpy()
        out[prefix] = np.asarray(tree)


def _unflatten(prefix: str, data: dict[str, np.ndarray],
               meta: dict[str, Any]) -> Any:
    info = meta[prefix]
    if info["kind"] == "dict":
        return {k: _unflatten(f"{prefix}/{k}", data, meta)
                for k in info["keys"]}
    if info["kind"] == "list":
        return [_unflatten(f"{prefix}/{i}", data, meta)
                for i in range(info["len"])]
    return data[prefix]


def content_checksum(arrays: dict[str, np.ndarray]) -> str:
    """Order-independent sha256 over every leaf's name, dtype, shape and
    bytes: what the meta block stores and the loader verifies."""
    h = hashlib.sha256()
    for k in sorted(arrays):
        a = np.ascontiguousarray(arrays[k])
        h.update(k.encode())
        h.update(str(a.dtype).encode())
        h.update(str(a.shape).encode())
        h.update(a.tobytes())
    return h.hexdigest()


def save_checkpoint(path: str, tree: Any) -> None:
    arrays: dict[str, np.ndarray] = {}
    meta: dict[str, Any] = {}
    _flatten(tree, "root", arrays, meta)
    meta["__checksum__"] = content_checksum(arrays)
    # a pid-stamped temporary name: a writer killed mid-write leaves an
    # orphan that never collides with a later writer's; the .npz suffix
    # keeps np.savez from appending its own
    tmp = f"{path}.tmp.{os.getpid()}.npz"
    np.savez(tmp, __meta__=np.frombuffer(
        json.dumps(meta).encode(), dtype=np.uint8), **arrays)
    os.replace(tmp, path)


def load_checkpoint(path: str, verify: bool = True) -> Any:
    try:
        with np.load(path) as z:
            meta = json.loads(bytes(z["__meta__"]).decode())
            data = {k: z[k] for k in z.files if k != "__meta__"}
    except (zipfile.BadZipFile, OSError, EOFError, ValueError, KeyError,
            json.JSONDecodeError) as e:
        raise CheckpointError(
            f"unreadable checkpoint ({type(e).__name__}: {e})", path) from e
    expect = meta.pop("__checksum__", None)
    if verify and expect is not None:
        got = content_checksum(data)
        if got != expect:
            raise CheckpointError(
                f"checksum mismatch (file says {expect[:12]}…, content is "
                f"{got[:12]}…): a truncated or bit-rotted snapshot", path)
    try:
        return _unflatten("root", data, meta)
    except (KeyError, IndexError, TypeError) as e:
        raise CheckpointError(
            f"malformed checkpoint structure ({type(e).__name__}: {e})",
            path) from e
