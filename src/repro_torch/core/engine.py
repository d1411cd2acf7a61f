"""SummaryEngine: Alg. 1's loop over a single-device backend.

Port of the local part of ``repro/core/engine.py``: ``theta_schedule_host``,
``SummaryEngine.run`` (θ schedule, stopping rule, ``ensure_budget`` rounds,
finalize) and ``LocalBackend``. Checkpointing, preemption and the straggler
monitor are not ported yet.

The engine walks the rounds in chunks of ``cfg.driver_chunk`` as the
reference's does. Inside a chunk the backend reads each round's scalars to
the host once (one sync a round) and ends the chunk early on the stopping
test the reference evaluates on the device: ``size_bits ≤ k`` in float32,
or no merge at θ = 0. At a chunk boundary the engine's own test compares in
float64, as the reference's host does, so both runs take the same rounds.
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


@dataclasses.dataclass
class EngineRun:
    """Everything Alg. 1 produced, before result assembly."""

    state: SummaryState
    history: list[dict]
    iterations_run: int
    input_size_bits: float
    finalize: dict[str, Any]  # backend payload from sparsify_finalize
    chunk_wall_s: list = dataclasses.field(default_factory=list)


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

    def run(self, collect_history: bool = True) -> EngineRun:
        """Drive Alg. 1 to the final summary."""
        cfg, backend = self.cfg, self.backend
        size_g = backend.input_size_bits()
        k_bits = cfg.target_bits(size_g)
        chunk = max(1, cfg.driver_chunk)

        history: list[dict] = []
        chunk_walls: list[float] = []
        last: dict | None = None
        stopped = False
        t = 1  # next round index
        extra_done = 0  # budget-feasibility rounds already run
        final = False
        state = backend.init()
        t_wall = time.perf_counter()

        def run_rounds(state, t0: int, limit: int, thetas: list[float]):
            t_disp = time.perf_counter()
            state, rows = backend.run_chunk(state, thetas, t0, k_bits, limit)
            chunk_walls.append(time.perf_counter() - t_disp)
            return state, rows

        while t <= cfg.T and not stopped:
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

        # budget-feasibility rounds: membership bits |V|log₂|S| must fit
        # under k before edge-dropping can finish
        if cfg.ensure_budget:
            v = backend.num_nodes
            while not final and extra_done < cfg.max_extra_iters:
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
                final = last["nmerges"] == 0
        iterations_run = t - 1

        finalize = backend.sparsify_finalize(state, k_bits)
        return EngineRun(state=state, history=history, iterations_run=iterations_run,
                         input_size_bits=size_g, finalize=finalize,
                         chunk_wall_s=chunk_walls)


class LocalBackend:
    """Single-device Alg. 1 primitives over an edge list held on ``device``.

    ``perms`` is the run's permutation source; by default a
    :class:`~repro_torch.core.shingles.TorchPermutations` seeded from
    ``cfg.seed`` on ``device``.
    """

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
            theta = costs.f32_scalar(thetas[i], self.device)
            state, stats = merge.merge_iteration(self.graph.src, self.graph.dst,
                                                 state, self.cfg, theta, self.perms)
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

    def sparsify_finalize(self, state: SummaryState, k_bits: float) -> dict:
        pt = costs.build_pair_table(self.graph.src, self.graph.dst, state)
        _drop, after = sparsify.further_sparsify(
            pt, state, self.num_nodes, self.num_edges, k_bits,
            cbar_mode=self.cfg.cbar_mode, re_guard=self.cfg.re_guard,
            error_p=self.cfg.error_p)
        return {"pair_table": pt, "keep": after["keep"], "after": after}
