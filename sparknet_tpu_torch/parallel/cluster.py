"""The launcher's env contract and the gang's process group.

The port's counterpart of ``sparknet_tpu/parallel/cluster.py`` (:24-133).
The launcher (``tools/launch.py``) sets SPARKNET_COORDINATOR /
SPARKNET_NUM_PROCS / SPARKNET_PROC_ID on every process it spawns.  A
world of one process joins nothing: its workers share the device.  A
world of N > 1 processes joins one ``torch.distributed`` group over gloo
(``tcp://$SPARKNET_COORDINATOR``, rank 0 hosting the store), the JAX
package's ``jax.distributed.initialize``.  NCCL needs a GPU a rank and
the card's machine has one, so every rank of a gang on the card runs on
``cuda:0`` and each collective is staged through host memory
(:func:`all_gather_tensors`).

The connect is retried with the JAX package's jittered backoff
(SPARKNET_CONNECT_RETRIES / _BACKOFF / _JITTER, defaults 3, 0.5 s and
0.25): rank 0 may bind its port after the others dial it, and a
relaunched gang re-dials all at once.  A join that still fails raises
:class:`ClusterConnectError`.  The group has a timeout (``timeout_s``);
a collective whose peer died or hung raises :class:`GangError` instead of
waiting forever.

The trainer (``parallel/trainer.py``) reads the world through
:func:`process_count` and :func:`process_index`; without a group they
are 1 and 0.
"""

from __future__ import annotations

import datetime
import os

from ..utils import knobs

# seconds a collective (and the join) may wait for a peer
GROUP_TIMEOUT_S = 300.0


class ClusterConnectError(RuntimeError):
    """The gang's process group could not be joined."""


class GangError(RuntimeError):
    """A collective of the gang failed: a peer died, hung past the
    group's timeout, or the link broke."""


def _dist():
    import torch.distributed as dist
    return dist


def _joined() -> bool:
    dist = _dist()
    return dist.is_available() and dist.is_initialized()


def init_cluster(coordinator_address: str, num_processes: int,
                 process_id: int, *,
                 timeout_s: float = GROUP_TIMEOUT_S) -> None:
    """Join the gang's gloo group at ``coordinator_address`` (host:port)
    as rank ``process_id`` of ``num_processes``; a no-op for a world of
    one.  The join is retried with jittered exponential backoff
    (SPARKNET_CONNECT_RETRIES / _BACKOFF / _JITTER); the last failure
    raises :class:`ClusterConnectError`."""
    if num_processes <= 1 or _joined():
        return
    from ..utils.retry import retry_call
    dist = _dist()
    host = coordinator_address.rsplit(":", 1)[0]
    if host in ("127.0.0.1", "localhost") and \
            not os.environ.get("GLOO_SOCKET_IFNAME"):
        # every rank on the local host: gloo's pairs ride the loopback
        # device, whatever the hostname resolves to (a sealed machine
        # may resolve it to nothing reachable)
        os.environ["GLOO_SOCKET_IFNAME"] = "lo"
    attempts = knobs.get_int("SPARKNET_CONNECT_RETRIES", 3)
    base = knobs.get_float("SPARKNET_CONNECT_BACKOFF", 0.5)
    jitter = knobs.get_float("SPARKNET_CONNECT_JITTER", 0.25)
    try:
        retry_call(
            dist.init_process_group, "gloo",
            init_method=f"tcp://{coordinator_address}",
            world_size=num_processes, rank=process_id,
            timeout=datetime.timedelta(seconds=timeout_s),
            attempts=attempts, base_delay=base, jitter=jitter,
            retry_on=(RuntimeError, OSError, ConnectionError, TimeoutError),
            describe="torch.distributed.init_process_group")
    except (RuntimeError, OSError, ConnectionError, TimeoutError) as e:
        raise ClusterConnectError(
            f"rank {process_id} of {num_processes} could not join the "
            f"gang at {coordinator_address} after {attempts} attempt(s) "
            f"({type(e).__name__}: {e})") from e


def init_cluster_from_env(*, timeout_s: float = GROUP_TIMEOUT_S) -> bool:
    """Join the gang described by SPARKNET_COORDINATOR /
    SPARKNET_NUM_PROCS / SPARKNET_PROC_ID.  False (and nothing joined)
    when the contract is absent, True when it is present: a world of one
    process joins no group, a larger world joins the gloo group.  A
    partial or malformed contract raises ValueError naming the
    variable."""
    addr = knobs.raw("SPARKNET_COORDINATOR")
    if not addr:
        for var in ("SPARKNET_NUM_PROCS", "SPARKNET_PROC_ID"):
            if knobs.raw(var):
                raise ValueError(
                    f"{var} is set but SPARKNET_COORDINATOR is not — the "
                    f"launcher env contract requires all three of "
                    f"SPARKNET_COORDINATOR / SPARKNET_NUM_PROCS / "
                    f"SPARKNET_PROC_ID")
        return False
    values = {}
    for var in ("SPARKNET_NUM_PROCS", "SPARKNET_PROC_ID"):
        raw = knobs.raw(var)
        if raw is None or raw == "":
            raise ValueError(
                f"SPARKNET_COORDINATOR is set but {var} is missing — the "
                f"launcher must export SPARKNET_COORDINATOR, "
                f"SPARKNET_NUM_PROCS, and SPARKNET_PROC_ID together")
        try:
            values[var] = int(raw)
        except ValueError:
            raise ValueError(
                f"{var}={raw!r} is not an integer") from None
    nprocs, pid = values["SPARKNET_NUM_PROCS"], values["SPARKNET_PROC_ID"]
    if nprocs < 1:
        raise ValueError(f"SPARKNET_NUM_PROCS={nprocs} must be >= 1")
    if not 0 <= pid < nprocs:
        raise ValueError(
            f"SPARKNET_PROC_ID={pid} out of range for "
            f"SPARKNET_NUM_PROCS={nprocs} (want 0 <= id < num_procs)")
    init_cluster(addr, nprocs, pid, timeout_s=timeout_s)
    return True


def shutdown_cluster() -> None:
    """Leave the gang's group (a no-op without one)."""
    if _joined():
        _dist().destroy_process_group()


def process_count() -> int:
    return _dist().get_world_size() if _joined() else 1


def process_index() -> int:
    return _dist().get_rank() if _joined() else 0


def is_multi_host() -> bool:
    return process_count() > 1


def local_batch_slice(global_batch: int) -> slice:
    """The half-open row range of the global batch this process feeds
    (the reference's partition placement, ImageNetApp.scala:145)."""
    n, i = process_count(), process_index()
    if global_batch % n:
        raise ValueError(f"global batch {global_batch} not divisible by "
                         f"{n} hosts")
    per = global_batch // n
    return slice(i * per, (i + 1) * per)


def _collective(what: str, fn, *args, **kwargs):
    try:
        return fn(*args, **kwargs)
    except RuntimeError as e:
        raise GangError(f"{what} across {process_count()} processes "
                        f"failed on rank {process_index()}: {e}") from e


def barrier() -> None:
    """Wait for every process of the gang (a no-op alone)."""
    if is_multi_host():
        _collective("barrier", _dist().barrier)


def all_gather_objects(obj) -> list:
    """Every process's ``obj`` (picklable), in rank order."""
    if not is_multi_host():
        return [obj]
    out = [None] * process_count()
    _collective("all_gather_object", _dist().all_gather_object, out, obj)
    return out


def all_gather_tensors(tensors: list) -> list[list]:
    """Every process's ``tensors``, in rank order: ``out[r][i]`` is rank
    r's i-th tensor, on the device and with the dtype and shape of this
    process's i-th.  Every process passes tensors of the same shapes and
    dtypes in the same order.  The bytes travel as one uint8 buffer
    through host memory (gloo gathers host tensors), so the values
    arrive bit for bit."""
    import torch
    if not is_multi_host():
        return [list(tensors)]
    flat = [t.detach().reshape(-1).contiguous() for t in tensors]
    raw = [f.cpu().view(torch.uint8) if f.numel() else
           torch.empty(0, dtype=torch.uint8) for f in flat]
    sizes = [r.numel() for r in raw]
    buf = torch.cat(raw) if raw else torch.empty(0, dtype=torch.uint8)
    outs = [torch.empty_like(buf) for _ in range(process_count())]
    _collective("all_gather", _dist().all_gather, outs, buf)
    result = []
    for r, out in enumerate(outs):
        if r == process_index():
            result.append(list(tensors))
            continue
        row, off = [], 0
        for t, n in zip(tensors, sizes):
            piece = out[off:off + n]
            off += n
            row.append(piece.view(t.dtype).reshape(t.shape).to(t.device)
                       if n else torch.empty(t.shape, dtype=t.dtype,
                                             device=t.device))
        result.append(row)
    return result


def global_max(value: int) -> int:
    """Max of a per-process integer over the gang (identity alone): the
    lockstep step count of an eval whose partitions differ in size."""
    return max(int(v) for v in all_gather_objects(int(value)))
