"""SummaryEngine: Alg. 1's loop over a single-device backend, crash-safe.

Port of ``repro/core/engine.py``: ``theta_schedule_host``,
``SummaryEngine.run`` (θ schedule, stopping rule, ``ensure_budget`` rounds,
finalize, with the salt ``t + 1`` passed to ``sparsify_finalize``),
``LocalBackend``, and the fault tolerance around the loop
(``EngineCheckpointer``, the fingerprints, ``global_preempt``). The
edge-sharded backend (:mod:`repro_torch.core.distributed`) plugs into the
same loop; across ranks the checkpoint is written by rank 0 and read whole
by every rank, and the preemption flag is agreed at every sync point.

The engine walks the rounds in chunks of ``cfg.driver_chunk`` as the
reference's does. Inside a chunk the backend reads each round's scalars to
the host once (one read-back a round) and ends the chunk early on the stopping
test the reference evaluates on the device: ``size_bits ≤ k`` in float32,
or no merge at θ = 0. At a chunk boundary the engine's own test compares in
float64, as the reference's host does, so both runs take the same rounds.

**Fault tolerance.** Everything Alg. 1 needs to continue from a chunk
boundary is the ``SummaryState`` (membership, sizes, round counter), the
position of the backend's permutation source (the port's state carries no
random key; :mod:`repro_torch.core.shingles`), and a small host payload: the
θ-schedule position ``t_next``, the stopping flag, the budget-loop position,
the phase marker, the last round's stats, the history, and the config and
graph fingerprints. :class:`EngineCheckpointer` saves them through
:class:`~repro_torch.runtime.checkpoint.CheckpointManager` (async, atomic,
keep-N) at the engine's host-sync points, and :meth:`SummaryEngine.run`
with ``resume=True`` checks the fingerprints and continues bit-identically:
each round is the same computation wherever the chunk boundaries fall, and
none of its sums depends on the order of the device's adds, on the card as
on the CPU (``costs.supernode_total_costs``). A
:class:`~repro_torch.runtime.elastic.PreemptionGuard`, polled at the same
points, turns SIGTERM/SIGINT into save-and-raise
:class:`~repro_torch.runtime.elastic.Preempted`.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any

import numpy as np
import torch

from repro_torch.core import costs, merge, sparsify
from repro_torch.core.shingles import PermutationSource, TorchPermutations
from repro_torch.core.types import (
    SummaryConfig,
    SummaryState,
    init_state,
    make_graph,
    resolve_device,
)
from repro_torch.runtime.checkpoint import CheckpointManager
from repro_torch.runtime.elastic import Preempted, PreemptionGuard
from repro_torch.runtime.straggler import StragglerMonitor
from repro_torch.utils.spans import span

# Per-round scalar stats of the local backend, in the reference's order.
LOCAL_STAT_KEYS = (
    "size_bits",
    "mdl_cost",
    "re1",
    "re2",
    "nmerges",
    "num_supernodes",
    "num_superedges",
    "total_reduction",
)


def theta_schedule_host(t: int, big_t: int) -> float:
    """Eq. (21) on the host — the float round ``t`` is fed (as float32)."""
    return 1.0 / (1.0 + t) if t < big_t else 0.0


def _world() -> tuple[int, int]:
    """``(rank, world size)`` of ``torch.distributed``'s default group;
    ``(0, 1)`` when it is not initialized."""
    dist = torch.distributed
    if not dist.is_available() or not dist.is_initialized():
        return 0, 1
    return dist.get_rank(), dist.get_world_size()


def global_preempt(local: bool) -> bool:
    """OR a preemption flag across every rank of the run.

    A signal lands on each rank at a different point of its loop; if one
    rank stopped at a sync point while another went on into the next
    round's collectives, the other would wait forever. So every sync point
    agrees on the flag: an ``all_reduce(MAX)`` over the default group (on
    the card over NCCL, on the CPU over gloo), and a rank that was
    signalled stops every rank at the same point. A single process returns
    the local flag.
    """
    if _world()[1] == 1:
        return bool(local)
    dist = torch.distributed
    # NCCL carries the flag on this process's current card (the one the
    # launcher or the bootstrap set), not on card 0
    dev = (torch.device("cuda", torch.cuda.current_device())
           if dist.get_backend() == "nccl" else torch.device("cpu"))
    flag = torch.tensor([int(bool(local))], dtype=torch.int32, device=dev)
    dist.all_reduce(flag, op=dist.ReduceOp.MAX)
    return bool(flag.item())


# ---------------------------------------------------------------------------
# Checkpoint and resume of Alg. 1's state
# ---------------------------------------------------------------------------


#: SummaryConfig fields left out of the resume fingerprint: scheduling only,
#: with bit-identical results for every value (tests/test_torch_resume.py),
#: so a run may resume with another chunking.
FINGERPRINT_EXEMPT = ("driver_chunk",)


def config_fingerprint(cfg: SummaryConfig) -> dict:
    """The config identity a checkpoint is only resumable under."""
    fp = dataclasses.asdict(cfg)
    for k in FINGERPRINT_EXEMPT:
        fp.pop(k, None)
    return fp


def graph_fingerprint(backend: "LocalBackend", extra: dict | None = None) -> dict:
    """Graph identity: |V|, |E| and the caller's provenance (e.g. the
    dataset or file name)."""
    fp = {"num_nodes": int(backend.num_nodes), "num_edges": int(backend.num_edges)}
    if extra:
        fp.update(extra)
    return fp


class FingerprintMismatch(ValueError):
    """A checkpoint was written under another config or graph."""


def _state_on_disk(state: SummaryState) -> SummaryState:
    """The state's leaves as the reference writes them: ``node2super`` and
    ``size`` int32 ``[V]``, ``t`` an int32 scalar (restored as int64, int)."""
    return SummaryState(node2super=state.node2super.to(torch.int32),
                        size=state.size.to(torch.int32), t=np.int32(state.t))


@dataclasses.dataclass
class EngineCheckpointer:
    """Chunk-boundary checkpointing policy around a CheckpointManager.

    ``every`` is the save cadence in *completed rounds*, aligned up to the
    engine's host-sync points (chunk boundaries): with ``driver_chunk=8``
    and ``every=1`` a save still happens only every 8 rounds. ``every <= 0``
    turns periodic saves off; the preemption save and the ``phase="final"``
    save (merge loop done, only sparsification left) always happen.

    ``guard`` wires preemption in: it is polled at every sync point, and on
    a pending signal the engine saves synchronously and raises
    :class:`~repro_torch.runtime.elastic.Preempted`.

    A save writes the ``SummaryState`` as leaves and, in the manifest's
    payload, the backend permutation source's ``state_dict()`` under
    ``"perms"``; a restore loads that back into the backend's source before
    the first resumed round.
    """

    manager: CheckpointManager
    every: int = 1
    guard: PreemptionGuard | None = None
    graph_extra: dict | None = None  # provenance merged into the graph fingerprint

    def fingerprints(self, backend: "LocalBackend") -> dict:
        return {"config": config_fingerprint(backend.cfg),
                "graph": graph_fingerprint(backend, self.graph_extra)}

    def due(self, completed: int, last_saved: int) -> bool:
        return self.every > 0 and completed - last_saved >= self.every

    def save(self, backend: "LocalBackend", state: SummaryState, payload: dict, *,
             sync: bool = False) -> int:
        """Save at a sync point. Across ranks every rank holds the same state:
        rank 0 writes it and waits for the commit, and every rank waits at a
        barrier until it is there, so no rank goes on (or exits) ahead of the
        checkpoint it would resume from."""
        step = int(payload["t_next"]) - 1  # completed rounds
        rank, world = _world()
        with span("ssumm.checkpoint"):
            if rank == 0:
                extra = dict(payload, fingerprints=self.fingerprints(backend),
                             perms=backend.perms.state_dict())
                self.manager.save_async(step, _state_on_disk(state), extra)
                if sync or world > 1:
                    self.manager.wait()
            if world > 1:
                torch.distributed.barrier()
        return step

    def restore(self, backend: "LocalBackend"):
        """Latest committed ``(state, payload, step)``, or None when nothing
        is committed. Checks the config and graph fingerprints against
        ``backend`` and puts the state on the backend's device. Across ranks
        each rank loads the whole state, whatever rank count wrote it."""
        if self.manager.latest_step() is None:
            return None
        state, step, payload = self.manager.restore(backend.init())
        want = self.fingerprints(backend)
        got = payload.get("fingerprints", {})
        for kind in ("config", "graph"):
            if got.get(kind) != want[kind]:
                have = got.get(kind, {})
                diff = {k: (have.get(k), want[kind].get(k))
                        for k in set(want[kind]) | set(have)
                        if have.get(k) != want[kind].get(k)}
                raise FingerprintMismatch(
                    f"checkpoint step {step} in {self.manager.dir!r} was written "
                    f"under a different {kind}: {{field: (checkpoint, current)}} = {diff}")
        backend.perms.load_state_dict(payload["perms"])
        return state, payload, step

    def preempted(self) -> bool:
        return self.guard is not None and self.guard.preempted


@dataclasses.dataclass
class EngineRun:
    """Everything Alg. 1 produced, before result assembly."""

    state: SummaryState
    history: list[dict]
    last_stats: dict | None  # stats of the last merge round (None if none ran)
    iterations_run: int
    input_size_bits: float
    k_bits: float
    finalize: dict[str, Any]  # backend payload from sparsify_finalize
    # host wall of sparsify_finalize, ended with no device sync of its own: on
    # the local backend on the card it times the enqueue of the finalize
    # path, not its device work (a profiler's ``ssumm.finalize`` span has that)
    sparsify_wall_s: float
    # fault tolerance and observability
    chunk_wall_s: list = dataclasses.field(default_factory=list)
    straggler_events: list = dataclasses.field(default_factory=list)
    resumed_from: int | None = None  # checkpoint step this run restarted at
    checkpoint_saves: int = 0
    checkpoint_snapshot_wall_s: float = 0.0  # the loop's stall for saves, total


class SummaryEngine:
    """Alg. 1 against a :class:`LocalBackend`."""

    def __init__(self, backend: "LocalBackend"):
        self.backend = backend
        self.cfg = backend.cfg

    def _should_stop(self, stats: dict, theta: float, k_bits: float) -> bool:
        if stats["size_bits"] <= k_bits:
            return True
        # converged: θ=0 accepts any cost-reducing merge; none left
        return stats["nmerges"] == 0 and theta == 0.0

    def run(self, collect_history: bool = True, *,
            checkpointer: EngineCheckpointer | None = None,
            monitor: StragglerMonitor | None = None,
            resume: bool = False) -> EngineRun:
        """Drive Alg. 1 to the final summary (optionally crash-safe).

        With a ``checkpointer``, the state, the permutation source's position
        and the loop position are saved (async, atomic) at chunk boundaries,
        and ``resume=True`` continues a prior run from its latest committed
        checkpoint, bit-identical to never having stopped. A pending
        preemption signal (``checkpointer.guard``) is honored at the same
        sync points: save synchronously, raise
        :class:`~repro_torch.runtime.elastic.Preempted`.

        ``monitor`` brackets every chunk with ``begin_step``/``end_step``;
        its flagged events land in ``EngineRun.straggler_events``, per-chunk
        wall times in ``EngineRun.chunk_wall_s``.
        """
        cfg, backend = self.cfg, self.backend
        size_g = backend.input_size_bits()
        k_bits = cfg.target_bits(size_g)
        chunk = max(1, cfg.driver_chunk)
        ck = checkpointer

        history: list[dict] = []
        chunk_walls: list[float] = []
        last: dict | None = None
        stopped = False
        t = 1  # next round index
        extra_done = 0  # budget-feasibility rounds already run
        phase = "loop"  # "loop" (merge or budget rounds left) | "final"
        resumed_from: int | None = None
        saves = 0
        last_saved = 0

        restored = None
        if resume:
            if ck is None:
                raise ValueError("resume=True requires a checkpointer")
            restored = ck.restore(backend)
        if restored is not None:
            state, payload, resumed_from = restored
            t = int(payload["t_next"])
            stopped = bool(payload["stopped"])
            extra_done = int(payload["extra_done"])
            phase = payload["phase"]
            last = payload["last_stats"]
            last_saved = t - 1
            if collect_history:
                history = list(payload["history"])
        else:
            state = backend.init()
        t_wall = time.perf_counter()

        def run_rounds(state, t0: int, limit: int, thetas: list[float]):
            if monitor is not None:
                monitor.begin_step()
            t_disp = time.perf_counter()
            state, rows = backend.run_chunk(state, thetas, t0, k_bits, limit)
            chunk_walls.append(time.perf_counter() - t_disp)
            if monitor is not None:
                monitor.end_step(t0)
            return state, rows

        def payload_now() -> dict:
            return {"t_next": t, "stopped": stopped, "extra_done": extra_done,
                    "phase": phase, "last_stats": last,
                    "history": history if collect_history else []}

        def sync_point(state, *, force: bool = False) -> None:
            """Host-sync bookkeeping: periodic save and preemption poll."""
            nonlocal saves, last_saved
            if ck is None:
                return
            preempt = ck.preempted()
            if ck.guard is not None:
                preempt = global_preempt(preempt)
            if force or preempt or ck.due(t - 1, last_saved):
                step = ck.save(backend, state, payload_now(), sync=preempt)
                saves += 1
                last_saved = t - 1
                if preempt:
                    raise Preempted(step)

        while phase == "loop" and t <= cfg.T and not stopped:
            limit = min(chunk, cfg.T - t + 1)
            thetas = [theta_schedule_host(tt, cfg.T) for tt in range(t, t + limit)]
            state, rows = run_rounds(state, t, limit, thetas)
            wall = time.perf_counter() - t_wall
            for i, row in enumerate(rows):
                last = row
                if collect_history:
                    history.append(dict(row, t=t + i, theta=thetas[i], wall_s=wall))
            t += len(rows)
            stopped = self._should_stop(last, thetas[len(rows) - 1], k_bits)
            sync_point(state)

        # budget-feasibility rounds: membership bits |V|log₂|S| must fit
        # under k before edge-dropping can finish. Each break is either
        # derived again from the restored state (membership, s_now) or kept
        # in the checkpoint's phase (the no-merge break), so a resumed run
        # walks the same extra rounds as an uninterrupted one.
        if cfg.ensure_budget:
            v = backend.num_nodes
            while phase == "loop" and extra_done < cfg.max_extra_iters:
                s_now = backend.num_supernodes(state)
                membership = v * float(np.log2(max(s_now, 2)))
                if membership <= k_bits or s_now <= 2:
                    break
                state, rows = run_rounds(state, t, 1, [0.0])
                last = rows[0]
                if collect_history:
                    history.append(dict(rows[0], t=t, theta=0.0,
                                        wall_s=time.perf_counter() - t_wall))
                t += 1
                extra_done += 1
                if last["nmerges"] == 0:
                    phase = "final"
                sync_point(state)
                if phase == "final":
                    break
        iterations_run = t - 1

        # merging is done: one last save, so a crash in the sparsification
        # resumes straight to finalize, with no merge round run again
        if phase != "final":
            phase = "final"
            sync_point(state, force=True)

        t_sp = time.perf_counter()
        with span("ssumm.finalize"):
            finalize = backend.sparsify_finalize(state, k_bits, iterations_run + 1)
        sparsify_wall_s = time.perf_counter() - t_sp
        snapshot_wall = 0.0
        if ck is not None:
            ck.manager.wait()  # raise an async write's error before returning
            snapshot_wall = sum(s["snapshot_wall_s"] or 0.0
                                for s in ck.manager.save_stats.values())
        return EngineRun(
            state=state, history=history, last_stats=last,
            iterations_run=iterations_run, input_size_bits=size_g, k_bits=k_bits,
            finalize=finalize, sparsify_wall_s=sparsify_wall_s,
            chunk_wall_s=chunk_walls,
            straggler_events=list(monitor.events) if monitor else [],
            resumed_from=resumed_from, checkpoint_saves=saves,
            checkpoint_snapshot_wall_s=snapshot_wall)


class LocalBackend:
    """Single-device Alg. 1 primitives over an edge list held on ``device``.

    ``perms`` is the run's permutation source; by default a
    :class:`~repro_torch.core.shingles.TorchPermutations` seeded from
    ``cfg.seed`` on ``device``.
    """

    stat_keys = LOCAL_STAT_KEYS

    def __init__(self, src, dst, num_nodes: int, cfg: SummaryConfig,
                 device: str | torch.device = "cuda",
                 perms: PermutationSource | None = None):
        self.device = resolve_device(device)
        self.graph, self.num_nodes = make_graph(src, dst, num_nodes, self.device)
        self.num_edges = self.graph.num_edges
        self.cfg = cfg
        self.perms = perms if perms is not None else TorchPermutations(cfg.seed,
                                                                       self.device)

    def input_size_bits(self) -> float:
        return costs.input_size_bits(self.num_nodes, self.num_edges)

    def init(self) -> SummaryState:
        return init_state(self.num_nodes, self.device)

    def run_chunk(self, state: SummaryState, thetas: list[float], t0: int,
                  k_bits: float, limit: int) -> tuple[SummaryState, list[dict]]:
        """Up to ``limit`` rounds (``thetas[i]`` is round ``t0 + i``'s θ);
        returns the new state and one row of float stats per round run
        (plus ``round_s``, the round's wall time)."""
        del t0  # the local rounds draw their randomness from self.perms alone
        k_f32 = np.float32(k_bits)
        rows = []
        for i in range(limit):
            t_round = time.perf_counter()
            with span("ssumm.round"):
                theta = costs.f32_scalar(thetas[i], self.device)
                state, stats = merge.merge_iteration(self.graph.src, self.graph.dst,
                                                     state, self.cfg, theta, self.perms)
                with span("ssumm.readback"):
                    vals = torch.stack([stats[k].to(torch.float32)
                                        for k in LOCAL_STAT_KEYS]).cpu().numpy()
            row = {k: float(x) for k, x in zip(LOCAL_STAT_KEYS, vals)}
            # host wall time of the round, ended by the read-back above
            row["round_s"] = time.perf_counter() - t_round
            rows.append(row)
            # the reference's device-side test: float32 size_bits vs float32 k
            size_f32 = vals[LOCAL_STAT_KEYS.index("size_bits")]
            if size_f32 <= k_f32 or (row["nmerges"] == 0 and thetas[i] == 0.0):
                break
        return state, rows

    def num_supernodes(self, state: SummaryState) -> int:
        return int((state.size > 0).sum())

    def sparsify_finalize(self, state: SummaryState, k_bits: float,
                          salt: int | None = None) -> dict:
        del salt  # the closed-form drop draws nothing
        pt = costs.build_pair_table(self.graph.src, self.graph.dst, state)
        _drop, after = sparsify.further_sparsify(
            pt, state, self.num_nodes, self.num_edges, k_bits,
            cbar_mode=self.cfg.cbar_mode, re_guard=self.cfg.re_guard,
            error_p=self.cfg.error_p)
        return {"pair_table": pt, "keep": after["keep"], "after": after}
