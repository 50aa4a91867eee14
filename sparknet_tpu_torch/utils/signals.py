"""Signal-driven snapshot and stop, the SignalHandler analog.

The port's own copy of ``sparknet_tpu/utils/signals.py`` (:24-81),
with its flight-recorder dump on SIGTERM (``utils/telemetry.py``).  The
reference
maps SIGINT and SIGHUP to solver actions checked between iterations
(reference: caffe/src/caffe/util/signal_handler.cpp:12-115; acted on in
``Solver::Step``, caffe/src/caffe/solver.cpp:270-281).  Handlers only set
flags; the training loop polls between rounds, so a snapshot is always
taken at a round boundary.  SIGTERM, a scheduler's preemption notice,
asks for a last snapshot and a clean stop.  Handlers can only be
installed from the main thread.
"""

from __future__ import annotations

import signal


class SolverAction:
    NONE = "none"
    STOP = "stop"
    SNAPSHOT = "snapshot"
    SNAPSHOT_STOP = "snapshot_stop"   # preemption: snapshot, then stop


class SignalGuard:
    """Install SIGINT -> stop, SIGHUP -> snapshot and SIGTERM -> snapshot
    and stop (each configurable); restore the previous handlers on
    exit."""

    def __init__(self, sigint_action: str = SolverAction.STOP,
                 sighup_action: str = SolverAction.SNAPSHOT,
                 sigterm_action: str = SolverAction.SNAPSHOT_STOP):
        self._actions = {signal.SIGINT: sigint_action,
                         signal.SIGHUP: sighup_action,
                         signal.SIGTERM: sigterm_action}
        self._pending: list[str] = []
        self._previous: dict[int, object] = {}

    def __enter__(self) -> "SignalGuard":
        for sig, action in self._actions.items():
            if action == SolverAction.NONE:
                continue
            self._previous[sig] = signal.signal(sig, self._on_signal)
        return self

    def _on_signal(self, signum, frame) -> None:
        self._pending.append(self._actions[signum])
        if signum == signal.SIGTERM:
            # the preemption notice is a flight-recorder moment: the
            # recent-event ring goes to disk before a kill can land
            from . import telemetry
            rec = telemetry.get_recorder()
            rec.record("sigterm", action=self._actions[signum])
            rec.dump("sigterm")

    def __exit__(self, *exc) -> None:
        for sig, prev in self._previous.items():
            signal.signal(sig, prev)

    def check(self) -> str:
        """The action requested since the last check
        (Solver::GetRequestedAction); consumes one pending request."""
        if self._pending:
            return self._pending.pop(0)
        return SolverAction.NONE


def preemption_guard() -> SignalGuard:
    """SIGTERM (the preemption notice) and SIGINT (a human ^C): a last
    snapshot and a clean stop, so an interrupted run can resume; SIGHUP:
    a snapshot, and the run goes on."""
    return SignalGuard(sigint_action=SolverAction.SNAPSHOT_STOP,
                       sighup_action=SolverAction.SNAPSHOT,
                       sigterm_action=SolverAction.SNAPSHOT_STOP)
