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
:class:`CheckpointError` naming the file.

Round checkpoints (``parallel/trainer.py``) add the JAX package's two
other pieces (:61-120, :277-446):

- **Incarnation fences.** A checkpoint directory carries a monotonic
  token (``FENCE.json``); a writer claims it with its own
  ``SPARKNET_FENCE_TOKEN`` and a writer whose token is below the claim
  is refused (:class:`CheckpointFencedError`) before its npz and again
  before its manifest appears.  Token 0 turns fencing off.
- **The asynchronous writer.** :func:`snapshot_tree` copies a tree to
  host memory without blocking (pinned buffers and a CUDA event on the
  card), and :class:`AsyncCheckpointWriter` serializes, checksums and
  renames on one background thread, in order, behind a bounded queue.
  ``SPARKNET_ASYNC_CKPT=0`` keeps every write synchronous.

Not ported: sharded split and join (ROADMAP A12).
"""

from __future__ import annotations

import atexit
import hashlib
import json
import os
import queue
import threading
import time
import weakref
import zipfile
from typing import Any, Callable

import numpy as np
import torch

from . import knobs


class CheckpointError(Exception):
    """A checkpoint file is missing, truncated, corrupt, or fails its
    checksum.  ``path`` names the offending file."""

    def __init__(self, message: str, path: str):
        super().__init__(f"{path}: {message}")
        self.path = path


class CheckpointFencedError(CheckpointError):
    """A writer from a fenced-off incarnation tried to publish into a
    directory a successor has claimed.  Carries the writer's ``token``
    and the directory's ``fence``."""

    def __init__(self, path: str, token: int, fence: int):
        super().__init__(
            f"incarnation fence: writer token {token} < dir fence "
            f"{fence}: a successor owns this checkpoint dir; refusing "
            f"to publish", path)
        self.token = token
        self.fence = fence


# -- incarnation fencing (the JAX package's utils/checkpoint.py:61-120) ----
FENCE_FILE = "FENCE.json"


def read_fence(directory: str) -> int:
    """The directory's fence token (0: never claimed, or unreadable)."""
    try:
        with open(os.path.join(directory, FENCE_FILE)) as f:
            return int(json.load(f)["token"])
    except (OSError, ValueError, KeyError, json.JSONDecodeError):
        return 0


def check_fence(directory: str, token: int) -> None:
    """Raise :class:`CheckpointFencedError` when ``directory`` has been
    claimed by a higher incarnation than ``token``."""
    fence = read_fence(directory)
    if fence > token:
        raise CheckpointFencedError(os.path.join(directory, FENCE_FILE),
                                    token, fence)


def advance_fence(directory: str, token: int) -> int:
    """Claim ``directory`` for incarnation ``token`` (a monotonic max,
    written tmp+rename) and return the fence.  A claim below the current
    fence raises: the claimant is the zombie."""
    check_fence(directory, token)
    fence = max(read_fence(directory), token)
    os.makedirs(directory, exist_ok=True)
    path = os.path.join(directory, FENCE_FILE)
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "w") as f:
        json.dump({"token": fence, "pid": os.getpid(),
                   "time": round(time.time(), 3)}, f)
    os.replace(tmp, path)
    return fence


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


# ---------------------------------------------------------------------------
# The asynchronous tier (the JAX package's utils/checkpoint.py:277-446)
# ---------------------------------------------------------------------------

def async_checkpoints_enabled() -> bool:
    """Whether round checkpoints are written in the background
    (``SPARKNET_ASYNC_CKPT=0`` keeps them synchronous)."""
    return knobs.raw("SPARKNET_ASYNC_CKPT", "") != "0"


class HostSnapshot:
    """A tree copied to host memory by :func:`snapshot_tree`; ``wait()``
    returns it once the copies have landed."""

    def __init__(self, tree: Any, event: "torch.cuda.Event | None"):
        self._tree = tree
        self._event = event

    def wait(self) -> Any:
        if self._event is not None:
            self._event.synchronize()
            self._event = None
        return self._tree


def snapshot_tree(tree: Any) -> HostSnapshot:
    """Copy every tensor leaf of ``tree`` to a host buffer of its own
    without blocking: a CUDA tensor into pinned memory with a
    non-blocking copy on the current stream, completed by one CUDA event
    the writer waits on (``HostSnapshot.wait``); a CPU tensor by a clone.
    No copy aliases its source, so the next round may update the params
    and state in place: its kernels queue behind the copies on the same
    stream.  Other leaves pass through."""
    on_card = False

    def snap(x):
        nonlocal on_card
        if isinstance(x, dict):
            return {k: snap(v) for k, v in x.items()}
        if isinstance(x, (list, tuple)):
            return [snap(v) for v in x]
        if not isinstance(x, torch.Tensor):
            return x
        x = x.detach()
        if not x.is_cuda:
            return x.clone()
        on_card = True
        out = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
        out.copy_(x, non_blocking=True)
        return out

    host = snap(tree)
    event = None
    if on_card:
        event = torch.cuda.Event()
        event.record()
    return HostSnapshot(host, event)


# every live writer, so a trainer that scans a directory (resume) can
# wait for writes still queued in another instance
_WRITERS: "weakref.WeakSet[AsyncCheckpointWriter]" = weakref.WeakSet()
_STOP = object()


class AsyncCheckpointWriter:
    """One background thread running checkpoint-write jobs in FIFO order
    behind a bounded queue.

    A job is a callable that performs one whole durable write (npz,
    manifest, prune) with its inputs captured when it was built.
    ``submit`` blocks only while ``depth`` jobs are queued, which bounds
    the host memory held by snapshots.  A job that raises parks its
    exception and later jobs still run; the error is raised by the next
    ``submit`` or ``flush``, where a synchronous write would have raised.
    ``flush()`` returns when every job submitted before it has finished."""

    def __init__(self, depth: int = 2, name: str = "ckpt-writer"):
        if depth < 1:
            raise ValueError(f"writer queue depth must be >= 1, got {depth}")
        self._q: "queue.Queue[Any]" = queue.Queue(maxsize=depth)
        self._cond = threading.Condition()
        self._submitted = 0
        self._completed = 0
        self._err: BaseException | None = None
        self._closed = False
        self._thread = threading.Thread(target=self._run, name=name,
                                        daemon=True)
        self._thread.start()
        _WRITERS.add(self)

    def _run(self) -> None:
        while True:
            job = self._q.get()
            if job is _STOP:
                return
            try:
                job()
            except BaseException as e:  # raised by the next submit/flush
                with self._cond:
                    if self._err is None:
                        self._err = e
            finally:
                with self._cond:
                    self._completed += 1
                    self._cond.notify_all()

    def _take_error(self) -> BaseException | None:
        with self._cond:
            e, self._err = self._err, None
            return e

    def submit(self, job: Callable[[], None]) -> None:
        """Queue one write job; blocks while the queue is full and
        raises the first parked error of an earlier job."""
        if self._closed:
            raise RuntimeError("checkpoint writer is closed")
        err = self._take_error()
        if err is not None:
            raise err
        with self._cond:
            self._submitted += 1
        self._q.put(job)

    def flush(self, raise_errors: bool = True) -> None:
        """Wait until every submitted job has finished; with
        ``raise_errors``, raise a parked job error here."""
        with self._cond:
            while self._completed < self._submitted:
                if not self._thread.is_alive():
                    break  # interpreter teardown killed the daemon
                self._cond.wait(0.1)
        if raise_errors:
            err = self._take_error()
            if err is not None:
                raise err

    def close(self, raise_errors: bool = False) -> None:
        """Flush, then stop the thread.  Safe to call twice."""
        if self._closed:
            return
        self.flush(raise_errors=raise_errors)
        self._closed = True
        self._q.put(_STOP)
        self._thread.join(timeout=5.0)
        _WRITERS.discard(self)


def flush_all_writers() -> None:
    """Wait for every live writer's queued jobs.  Errors stay parked on
    their writer, for its owner to raise."""
    for w in list(_WRITERS):
        w.flush(raise_errors=False)


# a normal interpreter exit must not drop queued round checkpoints; a
# crash (os._exit) still tears mid-write, which the tmp+rename order and
# the manifests' checksums exist to survive
atexit.register(flush_all_writers)
