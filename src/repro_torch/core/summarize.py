"""SSumM driver (Alg. 1): the public entry point of the port.

Port of ``repro/core/summarize.py``. ``summarize(src, dst, num_nodes, cfg)``

    1. initializes Ḡ := G,
    2. runs merge rounds while t ≤ T and Size(Ḡ) > k (plus the
       ``ensure_budget`` θ = 0 rounds while |V|log₂|S| > k),
    3. drops superedges until Size(Ḡ) ≤ k (further sparsification),

through :class:`~repro_torch.core.engine.SummaryEngine` on a
:class:`~repro_torch.core.engine.LocalBackend`. It runs on the card unless
the caller passes ``device="cpu"``; without CUDA the default raises. With a
``checkpointer`` the run is crash-safe and ``resume=True`` continues it
(``core/engine.py``).
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.engine import (
    EngineCheckpointer,
    EngineRun,
    LocalBackend,
    SummaryEngine,
)
from repro_torch.core.shingles import PermutationSource
from repro_torch.core.types import SummaryConfig, SummaryResult
from repro_torch.runtime.straggler import StragglerMonitor
from repro_torch.utils.spans import span


def summarize(src, dst, num_nodes: int, cfg: SummaryConfig = SummaryConfig(),
              device: str | torch.device = "cuda", collect_history: bool = True,
              perms: PermutationSource | None = None, *,
              checkpointer: EngineCheckpointer | None = None,
              monitor: StragglerMonitor | None = None,
              resume: bool = False) -> SummaryResult:
    """Run SSumM on an edge list; returns the summary graph + exact metrics.

    ``perms`` is the source of each round's permutations (default: a torch
    generator seeded from ``cfg.seed`` on ``device``). ``checkpointer``,
    ``monitor`` and ``resume`` pass through to
    :meth:`~repro_torch.core.engine.SummaryEngine.run`.
    """
    with span("ssumm.run"):
        backend = LocalBackend(src, dst, num_nodes, cfg, device=device, perms=perms)
        run = SummaryEngine(backend).run(collect_history=collect_history,
                                         checkpointer=checkpointer, monitor=monitor,
                                         resume=resume)
        with span("ssumm.to_host"):
            return _result(run)


def _result(run: EngineRun) -> SummaryResult:
    """The summary and its metrics copied to the host."""
    pt = run.finalize["pair_table"]
    after = run.finalize["after"]
    keep = run.finalize["keep"]
    scalars = torch.stack([after[k].to(torch.float32) for k in (
        "num_supernodes", "num_superedges", "size_bits", "re1", "re2", "mdl_cost")]
    ).cpu().numpy()
    n_s, n_p, size_bits, re1, re2, mdl = (float(x) for x in scalars)
    return SummaryResult(
        node2super=run.state.node2super.to(torch.int32).cpu().numpy(),
        super_size=run.state.size.to(torch.int32).cpu().numpy(),
        edge_lo=pt.lo[keep].to(torch.int32).cpu().numpy(),
        edge_hi=pt.hi[keep].to(torch.int32).cpu().numpy(),
        edge_w=pt.cnt[keep].cpu().numpy().astype(np.int64),
        num_supernodes=int(n_s),
        num_superedges=int(n_p),
        size_bits=size_bits,
        input_size_bits=float(run.input_size_bits),
        re1=re1,
        re2=re2,
        mdl_cost=mdl,
        iterations_run=run.iterations_run,
        history=run.history,
        chunk_wall_s=run.chunk_wall_s,
        straggler_events=run.straggler_events,
        resumed_from=run.resumed_from,
        checkpoint_saves=run.checkpoint_saves,
        checkpoint_snapshot_wall_s=run.checkpoint_snapshot_wall_s,
    )
