"""The paper's own workloads: SSumM graph-summarization configs.

Port copy of ``repro/configs/ssumm_paper.py``, over the port's
``SummaryConfig`` and synthetic ``DATASETS``. Small/mid datasets run for
real (synthetic Table-2 stand-ins); the reference marks the web-scale rows
dry-run-only (EXPERIMENTS.md §Dry-run), and the flag is kept as it is.
"""

from __future__ import annotations

import dataclasses

from repro_torch.core.types import SummaryConfig
from repro_torch.graphs.synthetic import DATASETS


@dataclasses.dataclass(frozen=True)
class GraphWorkload:
    dataset: str
    k_frac: float = 0.3
    cfg: SummaryConfig = SummaryConfig()
    dry_run_only: bool = False

    @property
    def v(self) -> int:
        return DATASETS[self.dataset].v

    @property
    def e(self) -> int:
        return DATASETS[self.dataset].e_target


WORKLOADS: dict[str, GraphWorkload] = {
    name: GraphWorkload(
        dataset=name,
        dry_run_only=name in ("web-uk-02", "web-uk-05", "livejournal", "skitter"),
    )
    for name in DATASETS
}

# benchmark defaults (paper Sect. 4.1: targets 10%–60% of Size(G), T=20)
TARGET_FRACS = [0.1, 0.2, 0.3, 0.4, 0.5, 0.6]
DEFAULT_T = 20
