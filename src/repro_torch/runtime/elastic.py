"""Preemption handling: SIGTERM/SIGINT → save at the next sync point, exit 75.

Port of the preemption half of ``repro/runtime/elastic.py``.
``PreemptionGuard`` turns SIGTERM/SIGINT into a cooperative "save and exit"
flag that the engine polls at every host-sync point; the checkpoint
manager's atomic commit keeps the save safe even if the grace period runs
out. A *second* signal means the grace period is over: the handler
hard-exits at once (``os._exit``) with the shell's ``128 + signum``,
leaving at worst an ignored ``.tmp-`` directory behind.

Drivers that committed a checkpoint before stopping raise :class:`Preempted`
and exit with :data:`RESUMABLE_EXIT` (BSD ``EX_TEMPFAIL``): a nonzero status
that a supervisor tells apart from a crash, meaning "rerun the same command
with ``--resume``". The elastic mesh planning of the reference
(``plan_mesh``, ``make_mesh_from_plan``) comes with the port's distributed
backend.
"""

from __future__ import annotations

import os
import signal

#: exit status of a run that checkpointed and stopped on SIGTERM/SIGINT:
#: nonzero (the work is unfinished) but resumable (EX_TEMPFAIL).
RESUMABLE_EXIT = 75


class Preempted(RuntimeError):
    """Raised at a host-sync point after a committed save-on-signal.

    ``step`` is the checkpoint step the run is resumable from.
    """

    def __init__(self, step: int):
        super().__init__(f"preempted; resumable from checkpoint step {step}")
        self.step = step


class PreemptionGuard:
    """Cooperative SIGTERM/SIGINT → checkpoint-and-exit flag.

    First signal: set :attr:`preempted`; the loop observes it at its next
    host-sync point, saves, and exits :data:`RESUMABLE_EXIT`. Second signal
    (the sender insists): hard-exit *from the handler* with
    ``hard_exit_code`` (default ``128 + signum``, the shell convention for
    death by signal). No save is attempted: the previous commit is the
    resume point, and a half-written ``.tmp-`` directory is ignored on
    restore and garbage-collected by the next save.
    """

    def __init__(self, signals=(signal.SIGTERM, signal.SIGINT),
                 hard_exit_code: int | None = None):
        self._requested = False
        self._count = 0
        self._hard_exit_code = hard_exit_code
        self._prev = {}
        for s in signals:
            try:
                self._prev[s] = signal.signal(s, self._handler)
            except ValueError:  # not the main thread
                pass

    def _handler(self, signum, frame):
        self._count += 1
        if self._count >= 2:
            code = self._hard_exit_code
            os._exit(128 + signum if code is None else code)
        self._requested = True

    @property
    def preempted(self) -> bool:
        return self._requested

    def restore(self) -> None:
        """Put back the handlers that were installed before the guard."""
        for s, h in self._prev.items():
            signal.signal(s, h)
