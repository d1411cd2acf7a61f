"""The multi-host bootstrap: one ``torch.distributed`` rank a process.

Port of ``repro/launch/mesh.py``'s :func:`bootstrap_distributed`, its
``SSUMM_*`` environment fallbacks and :class:`DistributedInfo`. Where the
reference initializes ``jax.distributed`` (its mesh then spans every
process), the port joins a ``torch.distributed`` process group of
``num_processes`` ranks through a TCP rendezvous at the coordinator: NCCL
for a card, gloo for the CPU. A rank is a process, so the port keeps no
mesh; the reference's pod-mesh functions (``make_production_mesh``,
``make_host_mesh``, ``mesh_device_count``) have no counterpart.

Launch the same command on every host with only the process id differing;
the coordinator is process 0's ``HOST:PORT``, where it listens.
"""

from __future__ import annotations

import dataclasses
import datetime
import os

import torch

from repro_torch.core.types import resolve_device

#: environment fallbacks for the bootstrap flags: one launch command can be
#: broadcast to every host with only these three variables differing.
COORDINATOR_ENV = "SSUMM_COORDINATOR"
NUM_PROCESSES_ENV = "SSUMM_NUM_PROCESSES"
PROCESS_ID_ENV = "SSUMM_PROCESS_ID"

#: how long the rendezvous and each collective wait for a peer before the
#: run fails (a missing or dead peer fails the run instead of hanging it)
TIMEOUT_S = 600.0


@dataclasses.dataclass(frozen=True)
class DistributedInfo:
    """What :func:`bootstrap_distributed` resolved for this process, and the
    device it runs on (the card it took, or the CPU)."""

    initialized: bool
    coordinator: str | None
    process_count: int
    process_index: int
    device: torch.device = torch.device("cpu")

    @property
    def is_main(self) -> bool:
        return self.process_index == 0

    def asdict(self) -> dict:
        return dict(dataclasses.asdict(self), device=str(self.device))


def _env_int(name: str) -> int | None:
    val = os.environ.get(name)
    return int(val) if val not in (None, "") else None


def resolve_flags(coordinator: str | None = None, num_processes: int | None = None,
                  process_id: int | None = None) -> tuple[str | None, int, int]:
    """``(coordinator, num_processes, process_id)`` by the reference's
    precedence: the arguments, then the ``SSUMM_*`` environment;
    ``num_processes`` is 1 when neither sets it. Raises ``ValueError`` when
    more than one process is asked for without a coordinator or a process id.
    """
    coordinator = coordinator or os.environ.get(COORDINATOR_ENV) or None
    if num_processes is None:
        num_processes = _env_int(NUM_PROCESSES_ENV)
    if process_id is None:
        process_id = _env_int(PROCESS_ID_ENV)
    if num_processes is None or num_processes <= 1:
        return None, 1, 0
    if coordinator is None or process_id is None:
        raise ValueError(
            f"multi-process bootstrap needs --coordinator and --process-id "
            f"(or ${COORDINATOR_ENV}/${PROCESS_ID_ENV}) alongside "
            f"num_processes={num_processes}")
    return coordinator, int(num_processes), int(process_id)


def bootstrap_distributed(coordinator: str | None = None,
                          num_processes: int | None = None,
                          process_id: int | None = None, *,
                          device: str | torch.device = "cuda") -> DistributedInfo:
    """Join the process group of ``num_processes`` ranks, one per process.

    The flags resolve as :func:`resolve_flags` says. With ``num_processes``
    unset or 1 nothing is initialized (``initialized=False``, the device as
    given). Otherwise this process joins as rank ``process_id`` through
    ``tcp://coordinator``, over NCCL for a CUDA ``device`` and gloo for the
    CPU, with :data:`TIMEOUT_S` bounding the rendezvous and every collective. On
    CUDA it takes the card ``cuda:LOCAL_RANK`` where that variable is set,
    else ``cuda:(process_id mod device_count)``, and makes it current.
    """
    coordinator, n, pid = resolve_flags(coordinator, num_processes, process_id)
    dev = resolve_device(device)
    if n == 1:
        return DistributedInfo(initialized=False, coordinator=None, process_count=1,
                               process_index=0, device=dev)
    dist = torch.distributed
    if dev.type == "cuda":
        if not dist.is_nccl_available():
            raise RuntimeError("a CUDA run across processes needs NCCL, and this "
                               "PyTorch has no NCCL; use --device cpu (gloo)")
        local = os.environ.get("LOCAL_RANK")
        index = int(local) if local not in (None, "") else pid % torch.cuda.device_count()
        dev = torch.device("cuda", index)
        torch.cuda.set_device(dev)
    # NCCL is told its card: left to guess, it takes the global rank's, which
    # is not this process's card on a second host
    dist.init_process_group("nccl" if dev.type == "cuda" else "gloo",
                            init_method=f"tcp://{coordinator}", rank=pid, world_size=n,
                            timeout=datetime.timedelta(seconds=TIMEOUT_S),
                            device_id=dev if dev.type == "cuda" else None)
    return DistributedInfo(initialized=True, coordinator=coordinator, process_count=n,
                           process_index=pid, device=dev)
