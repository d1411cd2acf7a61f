"""repro_torch.runtime — checkpoints, preemption and straggler detection.

Port of ``repro/runtime``: the atomic keep-N :class:`CheckpointManager`, the
cooperative :class:`PreemptionGuard` with :data:`RESUMABLE_EXIT`, and the
:class:`StragglerMonitor`. Host code only (numpy, threads, signals).
"""

from repro_torch.runtime.checkpoint import CheckpointManager
from repro_torch.runtime.elastic import RESUMABLE_EXIT, Preempted, PreemptionGuard
from repro_torch.runtime.straggler import StragglerEvent, StragglerMonitor

__all__ = [
    "CheckpointManager",
    "Preempted",
    "PreemptionGuard",
    "RESUMABLE_EXIT",
    "StragglerEvent",
    "StragglerMonitor",
]
