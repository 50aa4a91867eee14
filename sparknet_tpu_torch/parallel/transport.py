"""Pluggable host transport: the remote half of the fleet.

The port's own copy of ``sparknet_tpu/parallel/transport.py``.  Every
cross-host action the supervisor takes is one of three verbs:

  exec (``popen``)     start a command on a host with an env contract
  ship (``ship``)      move an artifact (a checkpoint) to a host
  beat (``beat_sync``) relay a host's heartbeat files back to the
                       supervisor's health dir

``LocalTransport``
    Direct spawn, copy-through ship, no beat relay (ranks beat straight
    into the supervisor's dir).

``SshTransport``
    Exec over ssh in the JAX package's wire format (``ssh -o
    BatchMode=yes <host> "cd <cwd> && env K='v' ... cmd"``).  The ssh
    binary is the ``SPARKNET_SSH_CMD`` knob, so a local fake-ssh script
    drives the real argv, env and stdio plumbing with no sshd.  Ship and
    beat relay use the shared-staging model (the fake-ssh rig shares a
    filesystem; a deployment points the staging root at a mount).

``ChaosTransport``
    A fault-injecting wrapper over either, driven by the network
    ``SPARKNET_FAULT`` kinds (``partition@host:h``, ``heal@host:h``,
    ``slow_link:<ms>@host:h``, ``drop_ship:<p>``, ``torn_ship``) and by
    ``partition()``/``heal()``/``set_slow()`` mid-episode.  A partitioned
    host's processes keep running: only new exec and ship calls fail and
    beats stop arriving, which the lease layer
    (``parallel/health.LeaseMonitor``) must call SUSPECT, never lost.

Shipping is resumable and verifies itself: chunks are read through
``data.objectstore.VerifyingStore`` (a crc32 a chunk, one fresh re-read
before declaring rot), each attempt resumes from the longest prefix of
whole chunks of the destination's temporary file that still matches the
source, the landed file is crc-checked whole, and the rename is atomic,
so a torn transfer can delay a ship but never land partial bytes.
``ship_latest_checkpoint`` pulls the newest valid round checkpoint
(manifest sha256 checked again at the destination) into a
checkpoint-less host's dir: the step before a requeued gang launches on
a machine that does not share the filesystem.  Knobs:
``SPARKNET_SHIP_CHUNK_MB`` (chunk size), ``SPARKNET_SHIP_RETRIES``
(attempts a ship).
"""

from __future__ import annotations

import glob
import hashlib
import json
import os
import shutil
import subprocess
import threading
import time
import zlib
from typing import Mapping, Sequence

from ..utils import knobs
from ..utils.retry import retry_call


class TransportError(OSError):
    """A transport verb failed; carries the host and the verb."""

    def __init__(self, msg: str, *, host: str | None = None,
                 op: str | None = None):
        super().__init__(msg)
        self.host = host
        self.op = op


class PartitionedError(TransportError):
    """The link to ``host`` is severed (the machine may well be alive)."""


class ShipError(TransportError):
    """An artifact transfer failed (dropped or torn mid-flight)."""


def _ship_chunk_bytes() -> int:
    mb = knobs.get_float("SPARKNET_SHIP_CHUNK_MB", 4.0)
    if mb <= 0:
        raise ValueError(f"SPARKNET_SHIP_CHUNK_MB must be > 0 (got {mb})")
    return max(int(mb * 1024 * 1024), 1)


def _ship_retries() -> int:
    n = knobs.get_int("SPARKNET_SHIP_RETRIES", 4)
    if n < 1:
        raise ValueError(f"SPARKNET_SHIP_RETRIES must be >= 1 (got {n})")
    return n


def _verified_copy(src: str, dst: str, *, chunk: int | None = None) -> dict:
    """One crc-verified, prefix-resumable copy attempt.

    Source chunks are read through a ``VerifyingStore`` (register crc,
    verified re-read — a flipped byte on the source medium is a typed
    ``DataCorruptionError``, not silent corruption shipped onward).  The
    destination temp keeps its longest src-matching whole-chunk prefix
    across attempts, so a torn previous transfer resumes instead of
    restarting.  The landed temp is re-read whole and crc-checked
    against the source before the atomic rename."""
    from ..data.objectstore import LocalStore, VerifyingStore

    chunk = chunk or _ship_chunk_bytes()
    store = VerifyingStore(LocalStore(os.path.dirname(src) or "."))
    key = os.path.basename(src)
    size = store.size(key)
    os.makedirs(os.path.dirname(dst) or ".", exist_ok=True)
    tmp = f"{dst}.tmp.ship"
    # resume: keep the longest prefix of whole chunks that still match
    resumed = 0
    if os.path.exists(tmp):
        have = os.path.getsize(tmp)
        with open(tmp, "rb") as f:
            while resumed < min(have, size):
                n = min(chunk, size - resumed)
                if n > have - resumed:
                    break
                got = f.read(n)
                want = store.checksum_range(key, resumed, n)
                if (zlib.crc32(got) & 0xFFFFFFFF) != want:
                    break
                resumed += n
    nchunks = 0
    with open(tmp, "r+b" if resumed else "wb") as out:
        out.seek(resumed)
        out.truncate(resumed)
        off = resumed
        while off < size:
            n = min(chunk, size - off)
            store.checksum_range(key, off, n)      # register…
            raw = store.open_range(key, off, n)    # …then verified read
            out.write(raw)
            off += n
            nchunks += 1
        out.flush()
        os.fsync(out.fileno())
    # whole-file read-back: a torn DESTINATION write must be caught here,
    # before the rename makes the file visible
    src_crc = 0
    for off in range(0, size, chunk):
        n = min(chunk, size - off)
        src_crc = zlib.crc32(store.open_range(key, off, n), src_crc)
    dst_crc = 0
    with open(tmp, "rb") as f:
        for blk in iter(lambda: f.read(chunk), b""):
            dst_crc = zlib.crc32(blk, dst_crc)
    if os.path.getsize(tmp) != size or (src_crc & 0xFFFFFFFF) != \
            (dst_crc & 0xFFFFFFFF):
        raise ShipError(f"shipped file mismatch for {src} -> {dst}: "
                        f"crc {dst_crc & 0xFFFFFFFF:#010x} != "
                        f"{src_crc & 0xFFFFFFFF:#010x}", op="ship")
    os.replace(tmp, dst)
    return {"bytes": size, "chunks": nchunks, "resumed_bytes": resumed}


class HostTransport:
    """The exec / ship / beat seam.  ``local`` transports spawn and beat
    in-place; remote ones wrap exec over a remote shell and relay beats
    from per-host staging dirs."""

    kind = "abstract"
    local = True

    def popen(self, host: str, cmd: Sequence[str], *,
              env_pairs: Sequence[tuple[str, str]],
              cwd: str | None = None,
              base_env: Mapping[str, str] | None = None
              ) -> subprocess.Popen:
        raise NotImplementedError

    def ship(self, src: str, host: str, dst: str) -> dict:
        """Move ``src`` to ``dst`` on ``host`` — crc-verified, resumable,
        with bounded backoff retry.  Returns the transfer record."""
        attempts = _ship_retries()
        return retry_call(self._ship_once, src, host, dst,
                          attempts=attempts, base_delay=0.05,
                          retry_on=(ShipError, OSError),
                          describe=f"ship {os.path.basename(src)} "
                                   f"-> {host}")

    def _ship_once(self, src: str, host: str, dst: str) -> dict:
        return _verified_copy(src, dst)

    def beat_sync(self, host: str, src_dir: str, dst_dir: str) -> int:
        """Relay ``host``'s beat files from its staging dir into the
        supervisor's health dir; returns files relayed."""
        raise NotImplementedError

    def describe(self) -> str:
        return self.kind


class LocalTransport(HostTransport):
    """Direct spawn on this machine.  Ranks beat straight into the
    supervisor's health dir, so the beat relay has nothing to move."""

    kind = "local"
    local = True

    def popen(self, host, cmd, *, env_pairs, cwd=None, base_env=None):
        env = dict(os.environ if base_env is None else base_env)
        env.update({k: str(v) for k, v in env_pairs})
        return subprocess.Popen(list(cmd), env=env, cwd=cwd,
                                stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT)

    def beat_sync(self, host, src_dir, dst_dir):
        return 0


def _sync_dir(src_dir: str, dst_dir: str) -> int:
    """Copy newer/changed flat files src -> dst (tmp + atomic rename, the
    beat-file discipline).  Missing source dir = nothing to relay."""
    try:
        names = os.listdir(src_dir)
    except OSError:
        return 0
    os.makedirs(dst_dir, exist_ok=True)
    moved = 0
    for name in names:
        s = os.path.join(src_dir, name)
        d = os.path.join(dst_dir, name)
        try:
            if not os.path.isfile(s):
                continue
            if os.path.exists(d) and os.path.getmtime(d) >= \
                    os.path.getmtime(s):
                continue
            tmp = f"{d}.tmp.{os.getpid()}"
            shutil.copy2(s, tmp)
            os.replace(tmp, d)
            moved += 1
        except OSError:
            continue   # a torn beat is just a missed beat; next tick
    return moved


class SshTransport(HostTransport):
    """Exec over ssh in the JAX package's wire format:

        <ssh> -o BatchMode=yes <host> "cd <cwd> && env K='v' ... cmd"

    ``<ssh>`` is the ``SPARKNET_SSH_CMD`` knob (default ``ssh``), which
    is how CI runs this exact argv through a local fake-ssh shim — the
    remote string, env-contract quoting, and stdio plumbing are the
    production code path, not a mock.  Ship and beat relay use the
    shared-staging model (see module docstring)."""

    kind = "ssh"
    local = False

    def __init__(self, ssh_cmd: str | None = None):
        self.ssh_cmd = ssh_cmd or knobs.get_str("SPARKNET_SSH_CMD", "ssh")

    def popen(self, host, cmd, *, env_pairs, cwd=None, base_env=None):
        cwd = cwd or os.getcwd()
        envs = " ".join(f"{k}={str(v)!r}" for k, v in env_pairs)
        remote = f"cd {cwd} && env {envs} " + " ".join(cmd)
        return subprocess.Popen(
            [self.ssh_cmd, "-o", "BatchMode=yes", host, remote],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT)

    def beat_sync(self, host, src_dir, dst_dir):
        return _sync_dir(src_dir, dst_dir)


class ChaosTransport(HostTransport):
    """Fault-injecting wrapper: consumes the network SPARKNET_FAULT kinds
    at construction (``net_specs``/``drop_ship``/``torn_ship`` on the
    process injector) and exposes ``partition``/``heal``/``set_slow``
    for programmatic mid-episode chaos (the soak harness's channel).

    Partition semantics are the whole point: running processes on a
    partitioned host are NOT touched — new popen/ship calls raise
    ``PartitionedError`` and ``beat_sync`` relays nothing, so the
    supervisor sees exactly what a severed link looks like."""

    local = False

    def __init__(self, inner: HostTransport, injector=None):
        self.inner = inner
        self.local = inner.local
        self._lock = threading.Lock()
        self._partitioned: set[str] = set()
        self._slow_ms: dict[str, float] = {}
        self._ship_seq = 0
        if injector is None:
            from ..utils import faults
            injector = faults.get_injector()
        self.injector = injector
        for spec in injector.net_specs():
            if spec.kind == "partition":
                self._partitioned.add(spec.host)
            elif spec.kind == "heal":
                self._partitioned.discard(spec.host)
            elif spec.kind == "slow_link":
                self._slow_ms[spec.host] = spec.delay_s * 1000.0

    @property
    def kind(self) -> str:                     # type: ignore[override]
        return f"chaos({self.inner.kind})"

    # -- chaos controls ---------------------------------------------------
    def partition(self, host: str) -> None:
        with self._lock:
            self._partitioned.add(host)

    def heal(self, host: str) -> None:
        with self._lock:
            self._partitioned.discard(host)

    def set_slow(self, host: str, ms: float) -> None:
        with self._lock:
            if ms > 0:
                self._slow_ms[host] = ms
            else:
                self._slow_ms.pop(host, None)

    def partitioned(self, host: str) -> bool:
        with self._lock:
            return host in self._partitioned

    def _toll(self, host: str, op: str) -> None:
        with self._lock:
            cut = host in self._partitioned
            slow = self._slow_ms.get(host, 0.0)
        if cut:
            raise PartitionedError(
                f"link to host {host!r} is partitioned ({op})",
                host=host, op=op)
        if slow > 0:
            time.sleep(slow / 1000.0)

    # -- verbs ------------------------------------------------------------
    def popen(self, host, cmd, *, env_pairs, cwd=None, base_env=None):
        self._toll(host, "exec")
        return self.inner.popen(host, cmd, env_pairs=env_pairs, cwd=cwd,
                                base_env=base_env)

    def _ship_once(self, src, host, dst):
        with self._lock:
            seq = self._ship_seq
            self._ship_seq += 1
        self._toll(host, "ship")
        if self.injector.drop_ship(seq):
            raise ShipError(f"ship #{seq} to {host!r} dropped by fault "
                            f"injection", host=host, op="ship")
        if self.injector.torn_ship():
            # leave a genuinely torn temp behind (half the source bytes)
            # and fail: the retry must resume past it — the whole-file
            # crc check guarantees the torn prefix can never land
            size = os.path.getsize(src)
            os.makedirs(os.path.dirname(dst) or ".", exist_ok=True)
            with open(src, "rb") as f, \
                    open(f"{dst}.tmp.ship", "wb") as out:
                out.write(f.read(max(size // 2, 1)))
            raise ShipError(f"ship #{seq} to {host!r} torn mid-transfer "
                            f"by fault injection", host=host, op="ship")
        return self.inner._ship_once(src, host, dst)

    def beat_sync(self, host, src_dir, dst_dir):
        with self._lock:
            if host in self._partitioned:
                return 0       # beats fall on the floor, silently
            slow = self._slow_ms.get(host, 0.0)
        if slow > 0:
            time.sleep(slow / 1000.0)
        return self.inner.beat_sync(host, src_dir, dst_dir)


def default_transport(addrs: Sequence[str] | None = None) -> HostTransport:
    """The transport the env asks for: ssh when SPARKNET_SSH_CMD is set
    or any address is genuinely remote, else local; chaos-wrapped when
    network fault specs are active."""
    from ..tools.launch import LOCAL_ADDRS
    from ..utils import faults
    remote = bool(knobs.get_str("SPARKNET_SSH_CMD", "")) or any(
        a not in LOCAL_ADDRS for a in (addrs or ()))
    base: HostTransport = SshTransport() if remote else LocalTransport()
    injector = faults.get_injector()
    if injector.net_specs() or any(
            s.kind in ("drop_ship", "torn_ship") for s in injector.specs):
        return ChaosTransport(base, injector)
    return base


# -- checkpoint shipping --------------------------------------------------

def newest_valid_round(ckpt_dir: str) -> int | None:
    """The newest round whose manifest parses and whose checkpoint file
    exists with the manifest's sha256 — the shippable state."""
    best = None
    for mpath in sorted(glob.glob(os.path.join(ckpt_dir,
                                               "manifest_*.json")),
                        reverse=True):
        try:
            with open(mpath) as f:
                man = json.load(f)
            path = os.path.join(ckpt_dir, man["file"])
            if _sha256(path) == man["sha256"]:
                r = int(man["round"])
                if best is None or r > best:
                    best = r
        except (OSError, ValueError, KeyError):
            continue
    return best


def _sha256(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for blk in iter(lambda: f.read(1 << 20), b""):
            h.update(blk)
    return h.hexdigest()


def ship_latest_checkpoint(transport: HostTransport, host: str,
                           src_dir: str, dst_dir: str) -> dict | None:
    """Pull the newest valid round checkpoint from ``src_dir`` into
    ``host``'s ``dst_dir`` — the pre-launch step for a gang requeued
    onto a machine with no local checkpoint state.  npz first, manifest
    last (the resume-visibility order save_checkpoint itself uses), both
    crc-verified chunked transfers; the landed npz is sha256-checked
    against the manifest before the manifest is made visible.  Returns
    the transfer record, or None when the source has nothing valid (a
    round-0 requeue launches cold, exactly like a fresh job)."""
    r = newest_valid_round(src_dir)
    if r is None:
        return None
    if os.path.realpath(src_dir) == os.path.realpath(dst_dir):
        return {"round": r, "bytes": 0, "skipped": "same dir"}
    have = newest_valid_round(dst_dir)
    if have is not None and have >= r:
        return {"round": have, "bytes": 0, "skipped": "up to date"}
    name = f"ckpt_round_{r:08d}.npz"
    mname = f"manifest_{r:08d}.json"
    t0 = time.monotonic()
    rec = transport.ship(os.path.join(src_dir, name), host,
                         os.path.join(dst_dir, name))
    with open(os.path.join(src_dir, mname)) as f:
        man = json.load(f)
    got = _sha256(os.path.join(dst_dir, name))
    if got != man["sha256"]:
        raise ShipError(
            f"shipped checkpoint {name} sha256 {got[:12]} != manifest "
            f"{str(man['sha256'])[:12]} on {host!r}", host=host, op="ship")
    mrec = transport.ship(os.path.join(src_dir, mname), host,
                          os.path.join(dst_dir, mname))
    return {"round": r, "bytes": rec["bytes"] + mrec["bytes"],
            "chunks": rec["chunks"], "resumed_bytes": rec["resumed_bytes"],
            "wall_s": round(time.monotonic() - t0, 4)}
