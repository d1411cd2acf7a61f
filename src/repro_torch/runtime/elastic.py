"""Elastic mesh planning and preemption handling.

Port of ``repro/runtime/elastic.py`` (numpy only there too).
:func:`plan_mesh` picks the (pod, data, model) factorization of a device
count, keeping the global batch: the trainer plans its ranks with it, and
takes the accumulation count it gives. ``make_mesh_from_plan`` has no
counterpart: a rank is a process, and the port builds no mesh.

``PreemptionGuard`` turns SIGTERM/SIGINT into a cooperative "save and exit"
flag that the engine polls at every host-sync point; the checkpoint
manager's atomic commit keeps the save safe even if the grace period runs
out. A *second* signal means the grace period is over: the handler
hard-exits at once (``os._exit``) with the shell's ``128 + signum``,
leaving at worst an ignored ``.tmp-`` directory behind.

Drivers that committed a checkpoint before stopping raise :class:`Preempted`
and exit with :data:`RESUMABLE_EXIT` (BSD ``EX_TEMPFAIL``): a nonzero status
that a supervisor tells apart from a crash, meaning "rerun the same command
with ``--resume``". A summarizer resumed on another number of ranks feeds
the edge shards again at that count (:mod:`repro_torch.graphs.feed`) and
loads the whole state on every rank.
"""

from __future__ import annotations

import dataclasses
import os
import signal

import numpy as np

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


@dataclasses.dataclass(frozen=True)
class MeshPlan:
    shape: tuple
    axes: tuple
    per_device_batch: int
    accum_steps: int

    @property
    def n_devices(self) -> int:
        return int(np.prod(self.shape))


def _divisors(n: int) -> list[int]:
    return [d for d in range(1, n + 1) if n % d == 0]


def plan_mesh(n_devices: int, *, global_batch: int, want_model: int = 16,
              want_pods: int = 1) -> MeshPlan:
    """Largest usable mesh for ``n_devices`` survivors.

    Picks model-axis size = the largest divisor of ``n_devices`` that is
    ≤ ``want_model`` (never grows TP beyond the tuned degree), then the pod
    axis, then data soaks up the rest. Per-device batch follows from the
    preserved global batch; if data-parallel width doesn't divide the global
    batch, gradient accumulation supplies the remainder.
    """
    model = max(d for d in _divisors(n_devices) if d <= want_model)
    rest = n_devices // model
    pods = max(d for d in _divisors(rest) if d <= want_pods)
    data = rest // pods
    if pods > 1:
        shape, axes = (pods, data, model), ("pod", "data", "model")
    else:
        shape, axes = (data, model), ("data", "model")
    dp = pods * data
    if global_batch % dp == 0:
        per_dev, accum = global_batch // dp, 1
    elif global_batch < dp:
        # fewer examples than DP shards (e.g. the summarize launcher's
        # batch-free plan): one per device, no accumulation
        per_dev, accum = 1, 1
    else:
        # smallest accumulation count that makes microbatches divide evenly
        accum = next(a for a in range(2, global_batch + 1)
                     if global_batch % (dp * a) == 0 or dp * a >= global_batch)
        per_dev = max(global_batch // (dp * accum), 1)
    return MeshPlan(shape=shape, axes=axes, per_device_batch=per_dev, accum_steps=accum)


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

    @property
    def signal_count(self) -> int:
        """Signals received since the guard was installed."""
        return self._count

    def restore(self) -> None:
        """Put back the handlers that were installed before the guard."""
        for s, h in self._prev.items():
            signal.signal(s, h)
