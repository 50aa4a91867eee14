"""Deterministic fault injection, to prove the recovery paths.

The port's own copy of ``sparknet_tpu/utils/faults.py`` (pure Python,
the whole grammar, so a ``SPARKNET_FAULT`` value means the same to both
packages).  SparkNet's recovery story was only ever exercised by luck
(a preempted EC2 spot node during a paper run); here every failure mode
is a deterministic test input.  Faults are described by the
``SPARKNET_FAULT`` env var and fire at well-defined hook points:

    SPARKNET_FAULT=<spec>[,<spec>...]
    spec     := kind[:arg][@round:<N>][@rank:<R>][@attempt:<A>]
    kind     := crash         — os._exit(43) at the start of round N
              | perma_crash   — os._exit(43) on EVERY attempt (a broken
                                host, not a transient death; needs @rank —
                                the elastic layer drops the rank once its
                                restart budget is spent)
              | hang          — block forever at the start of round N
              | straggle      — arg = duration: sleep that long at the
                                start of round N (a stuck-but-alive rank;
                                the straggler deadline must catch it)
              | slow_feed     — arg = per-batch delay ("200ms", "0.5s", "2")
              | nan_inject    — poison the round-N feed with NaNs (the
                                numerical-integrity guard must roll back)
              | corrupt_ckpt  — scribble over the checkpoint written at
                                round N, after its manifest exists
              | crash_in_ckpt — os._exit(43) mid-checkpoint-write at round
                                N: after the npz is durable but BEFORE the
                                manifest (the worst torn-write window —
                                resume must skip the orphan)
              | corrupt_record — arg = probability p in (0, 1]: flip bytes
                                in (and truncate) p·100% of the records a
                                DB feed decodes — rotting storage; the
                                quarantine layer must skip-and-count
              | feeder_die    — the prefetch feeder thread dies silently
                                (no error, no sentinel) before producing
                                batch N — the watchdog must detect the
                                dead thread and restart it once
              | feeder_hang   — arg = duration: the feeder blocks that
                                long before producing batch N (a stuck
                                read; the watchdog's stall timeout must
                                fire, not the job timeout)
              | bitflip_params — flip one mantissa bit in REPLICA R's
                                resident copy of the params at the start
                                of round N (@rank names the replica, not
                                the process — a flaky-HBM event; the
                                cross-replica audit must catch it before
                                the next averaging folds it in)
              | preempt       — deliver SIGTERM to THIS process at the
                                start of round N: the deterministic
                                replacement for a cloud scheduler's
                                preemption notice.  The preemption guard
                                (utils/signals.py SNAPSHOT_STOP) must
                                turn it into one final round checkpoint
                                + a clean rc-0 exit, and the fleet layer
                                must requeue-and-resume the job — NOT
                                count it complete
              | partition     — needs @host:NAME: sever the network link
                                to that host at the transport layer
                                (parallel/transport.ChaosTransport) —
                                its processes stay ALIVE but beats stop
                                arriving and new exec/ship calls fail.
                                The lease layer must mark the host
                                SUSPECT (never LOST) and suspend its
                                gang without burning restart budget
              | heal          — needs @host:NAME: undo a partition — the
                                link comes back, relayed beats flow
                                again, the suspended gang resumes
              | slow_link     — arg = per-operation delay ("50ms"),
                                needs @host:NAME: a degraded link — every
                                transport op to that host pays the delay
                                (the straggler-ATTRIBUTION case: slow,
                                not dead, and the blame must land on the
                                link, not the chip)
              | drop_ship     — arg = probability p in (0, 1]: each
                                artifact-shipping call fails with that
                                deterministic per-call probability — the
                                retry/backoff path must absorb it
              | torn_ship     — the next shipping call writes a partial
                                destination file then fails (a torn
                                transfer); the crc-verified resume must
                                detect and finish it, never serve the
                                torn prefix.  Fires once per process
              | bad_canary    — arg = model or version id: that serving
                                model's head produces NaN rows on EVERY
                                batch (a bad deployment, not a blip).
                                The engine's non-finite guard turns the
                                rows into typed failures, the per-version
                                SLO judge burns, and the rollout
                                controller must auto-roll back.  NOTE the
                                arg uses ':' (``bad_canary:mv-abc``), as
                                '@' is the modifier separator — it
                                matches the full versioned serving name,
                                its base model, or its version id

Scoping:
  @round:N   — fire at round N (required for crash/hang/straggle/
               nan_inject/crash_in_ckpt/bitflip_params; for feeder_die/
               feeder_hang N is the prefetch BATCH index; for
               corrupt_ckpt it names the checkpointed round; optional
               for perma_crash — default every round; slow_feed and
               corrupt_record ignore it)
  @rank:R    — only on process R (default: every rank; REQUIRED for
               perma_crash; for bitflip_params R names the target
               REPLICA on the mesh, not the process)
  @attempt:A — only on job attempt A.  The ResilientRunner stamps every
               (re)launch with SPARKNET_FAULT_ATTEMPT; crash / hang /
               straggle / corrupt_ckpt / crash_in_ckpt / nan_inject
               default to attempt 0 ONLY, so an injected fault fires once
               and the automatic restart then runs clean — the
               deterministic replacement for "the spot instance came
               back".  slow_feed and perma_crash default to every attempt
               (they model degradation and permanent loss, not a
               transient death).

nan_inject, bitflip_params, preempt, feeder_die, and feeder_hang
additionally fire at most once per process even without a restart: the guard/audit rollback
replays the same round index (and the restarted feeder replays the same
batch index), and the replay must run clean (the deterministic
replacement for "the cosmic ray does not strike twice").

Hook points in the port: ``feed_delay`` / ``feeder_event`` in
``data.prefetch.PrefetchIterator._before_pull``, ``corrupt_record`` in
``data.db.corrupt_record`` (the seam ``db_feed`` pulls through), and
``nan_inject`` / ``corrupt_checkpoint`` / ``on_checkpoint_write`` in
``parallel.trainer.DistributedTrainer``.  ``FaultInjector.on_round`` is
for training loops.  ``bitflip_params`` parses, but the trainer
refuses it: the cross-replica audit it exists for needs resident
replicas on several devices (ROADMAP A12).  The network kinds parse for
a transport layer the port does not have yet (ROADMAP A12).
"""

from __future__ import annotations

import dataclasses
import os
import signal
import sys
import time
import zlib
from typing import Callable, Mapping

KINDS = ("crash", "perma_crash", "hang", "straggle", "slow_feed",
         "nan_inject", "corrupt_ckpt", "crash_in_ckpt", "corrupt_record",
         "feeder_die", "feeder_hang", "bitflip_params", "preempt",
         "partition", "heal", "slow_link", "drop_ship", "torn_ship",
         "bad_canary")

# the network kinds: consumed by parallel/transport.ChaosTransport, not
# by the in-process hook points
NET_KINDS = ("partition", "heal", "slow_link", "drop_ship", "torn_ship")
# network kinds that must name the host whose link they describe
_NEED_HOST = ("partition", "heal", "slow_link")

# kinds that keep firing on every job attempt unless @attempt pins one
# (network state belongs to the link, not to any one attempt)
_EVERY_ATTEMPT = ("slow_feed", "perma_crash", "corrupt_record",
                  "bad_canary") + NET_KINDS
# kinds whose ':' arg is a duration
_DURATION_ARG = ("slow_feed", "straggle", "feeder_hang", "slow_link")
# kinds whose ':' arg is a probability in (0, 1]
_PROB_ARG = ("corrupt_record", "drop_ship")
# kinds whose ':' arg names a serving model / version ('@' is taken by
# the modifier grammar, so the name rides the ':' arg)
_NAME_ARG = ("bad_canary",)
# kinds that must name a round (for feeder_* the "round" is the batch
# sequence index the prefetch feeder is about to produce)
_NEED_ROUND = ("crash", "hang", "straggle", "nan_inject", "crash_in_ckpt",
               "feeder_die", "feeder_hang", "bitflip_params", "preempt")


@dataclasses.dataclass(frozen=True)
class FaultSpec:
    kind: str
    round: int | None = None
    rank: int | None = None
    attempt: int | None = None     # None => kind-specific default (see doc)
    delay_s: float = 0.0           # slow_feed/straggle/feeder_hang/slow_link
    prob: float = 0.0              # corrupt_record / drop_ship only
    host: str | None = None        # partition / heal / slow_link only
    model: str | None = None       # bad_canary only


def _parse_duration(text: str) -> float:
    t = text.strip()
    try:
        if t.endswith("ms"):
            return float(t[:-2]) / 1000.0
        if t.endswith("s"):
            return float(t[:-1])
        return float(t)
    except ValueError:
        raise ValueError(f"bad duration {text!r} (want e.g. '200ms', "
                         f"'1.5s', or plain seconds)") from None


def parse_faults(text: str) -> tuple[FaultSpec, ...]:
    """Parse a SPARKNET_FAULT value; raises ValueError with the offending
    spec named (config errors must be loud, not silently inert)."""
    specs = []
    for raw in text.split(","):
        raw = raw.strip()
        if not raw:
            continue
        head, *mods = raw.split("@")
        kind, _, arg = head.partition(":")
        kind = kind.strip()
        if kind not in KINDS:
            raise ValueError(f"unknown fault kind {kind!r} in {raw!r} "
                             f"(known: {', '.join(KINDS)})")
        delay = 0.0
        prob = 0.0
        model: str | None = None
        if kind in _NAME_ARG:
            if not arg:
                raise ValueError(
                    f"{kind} needs a model-or-version arg in {raw!r} "
                    f"(e.g. 'bad_canary:mv-abc123' — ':' not '@', the "
                    f"'@' is the modifier separator)")
            model = arg.strip()
        elif kind in _DURATION_ARG:
            if not arg:
                raise ValueError(f"{kind} needs a duration arg in {raw!r}")
            delay = _parse_duration(arg)
        elif kind in _PROB_ARG:
            if not arg:
                raise ValueError(
                    f"{kind} needs a probability arg in {raw!r}")
            try:
                prob = float(arg)
            except ValueError:
                raise ValueError(
                    f"bad probability {arg!r} in {raw!r}") from None
            if not 0.0 < prob <= 1.0:
                raise ValueError(
                    f"{kind} probability must be in (0, 1], got {prob} "
                    f"({raw!r})")
        elif arg:
            raise ValueError(f"{kind} takes no ':' arg (got {raw!r})")
        fields: dict[str, int] = {}
        host: str | None = None
        for mod in mods:
            key, _, val = mod.partition(":")
            key = key.strip()
            if key not in ("round", "rank", "attempt", "host") or not val:
                raise ValueError(f"bad modifier {mod!r} in {raw!r} "
                                 f"(want @round:N / @rank:R / @attempt:A "
                                 f"/ @host:NAME)")
            if key == "host":
                host = val.strip()
                continue
            try:
                fields[key] = int(val)
            except ValueError:
                raise ValueError(
                    f"modifier {mod!r} in {raw!r}: not an integer") from None
        if kind in _NEED_ROUND and "round" not in fields:
            raise ValueError(f"{kind} needs @round:N ({raw!r})")
        if kind in _NEED_HOST and host is None:
            raise ValueError(f"{kind} needs @host:NAME ({raw!r}) — a "
                             f"link fault must name whose link")
        if host is not None and kind not in NET_KINDS:
            raise ValueError(f"{kind} takes no @host modifier ({raw!r})")
        if kind == "perma_crash" and "rank" not in fields:
            raise ValueError(
                f"perma_crash needs @rank:R ({raw!r}) — a rankless "
                f"permanent crash means no survivor set to re-form with")
        if kind == "bitflip_params" and "rank" not in fields:
            raise ValueError(
                f"bitflip_params needs @rank:R ({raw!r}) — it must name "
                f"WHICH replica's resident copy rots, or the audit has "
                f"nothing to disagree about")
        specs.append(FaultSpec(kind=kind, round=fields.get("round"),
                               rank=fields.get("rank"),
                               attempt=fields.get("attempt"),
                               delay_s=delay, prob=prob, host=host,
                               model=model))
    return tuple(specs)


class FaultInjector:
    """Evaluates parsed fault specs at the hook points.  ``_exit`` and
    ``_sleep`` are injectable for unit tests; production uses the real
    ones (crash must be un-catchable, like a SIGKILLed worker)."""

    def __init__(self, specs: tuple[FaultSpec, ...], *, attempt: int = 0,
                 rank: int = 0,
                 _exit: Callable[[int], None] = os._exit,
                 _sleep: Callable[[float], None] = time.sleep,
                 _kill: Callable[[int, int], None] = os.kill):
        self.specs = specs
        self.attempt = attempt
        self.rank = rank
        self._exit = _exit
        self._sleep = _sleep
        self._kill = _kill
        self._fired: set[FaultSpec] = set()   # once-per-process kinds

    @classmethod
    def from_env(cls, env: Mapping[str, str] | None = None,
                 **kwargs) -> "FaultInjector":
        env = os.environ if env is None else env
        text = env.get("SPARKNET_FAULT", "")
        return cls(parse_faults(text) if text else (),
                   attempt=int(env.get("SPARKNET_FAULT_ATTEMPT", "0") or 0),
                   rank=int(env.get("SPARKNET_PROC_ID", "0") or 0),
                   **kwargs)

    def _active(self, spec: FaultSpec, rank: int | None) -> bool:
        r = self.rank if rank is None else rank
        if spec.rank is not None and spec.rank != r:
            return False
        want = spec.attempt
        if want is None:
            # one-shot faults fire on the first attempt only; degradation
            # and permanent-loss kinds fire on every attempt
            want = None if spec.kind in _EVERY_ATTEMPT else 0
        return want is None or want == self.attempt

    def on_round(self, round_idx: int, rank: int | None = None) -> None:
        """Call at the start of every training round."""
        for spec in self.specs:
            if spec.kind not in ("crash", "perma_crash", "hang", "straggle",
                                 "preempt"):
                continue
            if spec.kind == "perma_crash":
                if spec.round is not None and spec.round != round_idx:
                    continue
            elif spec.round != round_idx:
                continue
            if not self._active(spec, rank):
                continue
            if spec.kind == "preempt" and spec in self._fired:
                continue
            who = self.rank if rank is None else rank
            print(f"FAULT: {spec.kind} at round {round_idx} on rank {who} "
                  f"(attempt {self.attempt})", file=sys.stderr, flush=True)
            if spec.kind in ("crash", "perma_crash"):
                self._exit(43)
                return  # only reached with a test-injected _exit
            if spec.kind == "straggle":
                self._sleep(spec.delay_s)
                continue  # a straggler resumes (if it survives that long)
            if spec.kind == "preempt":
                # the preemption notice: SIGTERM to ourselves, exactly as
                # a cloud scheduler's grace window starts.  Once per
                # process — the round that observes the flag checkpoints
                # and exits, and the resumed process is PAST this round
                self._fired.add(spec)
                self._kill(os.getpid(), signal.SIGTERM)
                continue  # training continues until the guard polls
            while True:  # hang: a stuck worker, killable only from outside
                self._sleep(3600)

    def feed_delay(self, rank: int | None = None) -> float:
        """Seconds each prefetched batch should be delayed by."""
        return sum(s.delay_s for s in self.specs
                   if s.kind == "slow_feed" and self._active(s, rank))

    def nan_inject(self, round_idx: int, rank: int | None = None) -> bool:
        """True when the round-``round_idx`` feed should be poisoned with
        NaNs on this rank.  Fires at most ONCE per process per spec: the
        guard's rollback replays the same round index and the replay must
        run clean (see module docstring)."""
        for spec in self.specs:
            if (spec.kind != "nan_inject" or spec.round != round_idx
                    or spec in self._fired
                    or not self._active(spec, rank)):
                continue
            self._fired.add(spec)
            return True
        return False

    def corrupt_checkpoint(self, round_idx: int,
                           rank: int | None = None) -> bool:
        """True when the checkpoint just written for ``round_idx`` should
        be scribbled over (exercises manifest-fallback on resume)."""
        return any(
            s.kind == "corrupt_ckpt"
            and (s.round is None or s.round == round_idx)
            and self._active(s, rank)
            for s in self.specs)

    def on_checkpoint_write(self, round_idx: int,
                            rank: int | None = None) -> None:
        """Call between a round-checkpoint's npz write and its manifest
        write — the torn-write window ``crash_in_ckpt`` kills in (the
        orphan npz without a manifest must be invisible to resume)."""
        for spec in self.specs:
            if (spec.kind != "crash_in_ckpt" or spec.round != round_idx
                    or not self._active(spec, rank)):
                continue
            who = self.rank if rank is None else rank
            print(f"FAULT: crash_in_ckpt at round {round_idx} on rank "
                  f"{who} (attempt {self.attempt})", file=sys.stderr,
                  flush=True)
            self._exit(43)
            return  # only reached with a test-injected _exit

    def corrupt_record(self, seq: int, rank: int | None = None) -> bool:
        """True when decoded record number ``seq`` (a feed-lifetime
        sequence counter) should be handed corrupted bytes.  The choice is
        a pure function of ``seq`` so a restarted feed re-corrupts the
        SAME records — corruption on disk does not move around."""
        for spec in self.specs:
            if spec.kind != "corrupt_record" or not self._active(spec, rank):
                continue
            # deterministic per-record coin flip at probability spec.prob
            h = zlib.crc32(f"corrupt_record:{seq}".encode()) & 0xFFFFFFFF
            if h < spec.prob * 2**32:
                return True
        return False

    def net_specs(self) -> tuple[FaultSpec, ...]:
        """The active network-fault specs (partition/heal/slow_link) —
        ``parallel.transport.ChaosTransport`` seeds its link state from
        these at construction time."""
        return tuple(s for s in self.specs
                     if s.kind in ("partition", "heal", "slow_link")
                     and self._active(s, None))

    def drop_ship(self, seq: int) -> bool:
        """True when shipping call number ``seq`` should fail — a pure
        function of ``seq`` (like ``corrupt_record``) so a retried ship
        sequence hits the SAME drops on replay."""
        for spec in self.specs:
            if spec.kind != "drop_ship" or not self._active(spec, None):
                continue
            h = zlib.crc32(f"drop_ship:{seq}".encode()) & 0xFFFFFFFF
            if h < spec.prob * 2**32:
                return True
        return False

    def torn_ship(self) -> bool:
        """True when the NEXT shipping call should tear mid-transfer
        (partial destination bytes, then failure).  At most once per
        process: the resumed transfer must run clean."""
        for spec in self.specs:
            if (spec.kind != "torn_ship" or spec in self._fired
                    or not self._active(spec, None)):
                continue
            self._fired.add(spec)
            return True
        return False

    def feeder_event(self, batch_idx: int,
                     rank: int | None = None) -> tuple[str, float] | None:
        """("die", 0) / ("hang", duration) when the prefetch feeder should
        fail before producing batch ``batch_idx``, else None.  Fires at
        most once per process per spec: the watchdog's one-shot feeder
        restart replays the same batch index and must run clean."""
        for spec in self.specs:
            if (spec.kind not in ("feeder_die", "feeder_hang")
                    or spec.round != batch_idx or spec in self._fired
                    or not self._active(spec, rank)):
                continue
            self._fired.add(spec)
            who = self.rank if rank is None else rank
            print(f"FAULT: {spec.kind} before batch {batch_idx} on rank "
                  f"{who} (attempt {self.attempt})", file=sys.stderr,
                  flush=True)
            if spec.kind == "feeder_die":
                return ("die", 0.0)
            return ("hang", spec.delay_s)

    def bad_canary(self, model: str, rank: int | None = None) -> bool:
        """True when serving model ``model`` should produce NaN rows on
        this batch.  Fires on EVERY batch (a bad deployment stays bad —
        the rollout judge needs a sustained burn, not a blip).  The spec
        arg matches the full versioned serving name, its base model, or
        bare version id, so a soak can plant the fault by version alone
        (``bad_canary:mv-abc123``)."""
        for spec in self.specs:
            if spec.kind != "bad_canary" or not self._active(spec, rank):
                continue
            want = spec.model or ""
            if (model == want
                    or model.rsplit("@", 1)[-1] == want
                    or model.split("@", 1)[0] == want):
                return True
        return False

    def bitflip_rank(self, round_idx: int) -> int | None:
        """The replica index whose resident params should get a bit
        flipped at the start of round ``round_idx``, or None.  NOTE:
        unlike every other kind, @rank names the target REPLICA (mesh
        position), not the calling process — a single-process mesh of N
        virtual devices still has N replicas to rot.  Fires at most once
        per process per spec (the audit's rollback replay runs clean)."""
        for spec in self.specs:
            if (spec.kind != "bitflip_params" or spec.round != round_idx
                    or spec in self._fired):
                continue
            want = spec.attempt if spec.attempt is not None else 0
            if want != self.attempt:
                continue
            self._fired.add(spec)
            return spec.rank
        return None


_CACHE: tuple[tuple[str, ...], FaultInjector] | None = None


def get_injector() -> FaultInjector:
    """Process-wide injector, re-parsed whenever the driving env vars
    change (so tests can monkeypatch the env between uses).  Note the
    once-per-process state (``nan_inject``) lives in the cached instance:
    tests that reuse an identical SPARKNET_FAULT value across cases must
    call :func:`reset_injector` to re-arm it."""
    global _CACHE
    from . import knobs
    key = tuple(knobs.raw(k, "") for k in
                ("SPARKNET_FAULT", "SPARKNET_FAULT_ATTEMPT",
                 "SPARKNET_PROC_ID"))
    if _CACHE is None or _CACHE[0] != key:
        _CACHE = (key, FaultInjector.from_env())
    return _CACHE[1]


def reset_injector() -> None:
    """Drop the process-wide injector (and its fired-once memory)."""
    global _CACHE
    _CACHE = None


def corrupt_bytes(raw: bytes, seq: int) -> bytes:
    """Deterministically rot one record: XOR-flip three bytes at
    seq-derived positions and drop the final byte (a torn read).  The
    truncation guarantees a length-delimited decoder notices — a flip
    that lands inside pixel payload alone would be silent corruption,
    which is the object-store checksum tier's job to catch, not the
    decoder's."""
    if not raw:
        return raw
    buf = bytearray(raw[:-1] if len(raw) > 1 else raw)
    for i in range(3):
        if not buf:
            break
        pos = zlib.crc32(f"corrupt_bytes:{seq}:{i}".encode()) % len(buf)
        buf[pos] ^= 0x5A
    return bytes(buf)


def scribble(path: str) -> None:
    """Corrupt a file in place: truncate to half and overwrite the tail —
    breaks both the zip directory of an .npz and any content checksum."""
    size = os.path.getsize(path)
    with open(path, "r+b") as f:
        f.truncate(max(size // 2, 1))
        f.seek(max(size // 2 - 64, 0))
        f.write(b"\xde\xad\xbe\xef" * 4)
