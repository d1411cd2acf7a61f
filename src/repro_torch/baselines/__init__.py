"""The paper's competitor baselines (k-Gs, S2L, SAA-Gs), port of
``repro/baselines``: the greedy loops on the host, S2L's k-means and every
partition's evaluation on the caller's device."""

from repro_torch.baselines.common import BaselineResult, evaluate_partition
from repro_torch.baselines.kgs import summarize_kgs
from repro_torch.baselines.s2l import summarize_s2l
from repro_torch.baselines.saa_gs import summarize_saa_gs

__all__ = [
    "BaselineResult",
    "evaluate_partition",
    "summarize_kgs",
    "summarize_s2l",
    "summarize_saa_gs",
]
