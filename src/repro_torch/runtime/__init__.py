"""repro_torch.runtime — checkpoints, preemption and straggler detection.

Port of ``repro/runtime``: the atomic keep-N :class:`CheckpointManager`, the
cooperative :class:`PreemptionGuard` with :data:`RESUMABLE_EXIT`, the
:class:`StragglerMonitor` and the mesh planner :func:`plan_mesh`. Host code
only (numpy, threads, signals).
"""

from repro_torch.runtime.checkpoint import CheckpointManager
from repro_torch.runtime.elastic import (RESUMABLE_EXIT, MeshPlan, Preempted, PreemptionGuard,
                                         plan_mesh)
from repro_torch.runtime.straggler import StragglerEvent, StragglerMonitor

__all__ = [
    "CheckpointManager",
    "MeshPlan",
    "Preempted",
    "PreemptionGuard",
    "RESUMABLE_EXIT",
    "plan_mesh",
    "StragglerEvent",
    "StragglerMonitor",
]
