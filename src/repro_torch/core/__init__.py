"""repro_torch.core — SSumM's single-device summarization (Alg. 1) in PyTorch.

Port of ``repro/core``: the closed-form MDL costs, min-hash candidate groups,
union-space group tables, the merge round and the final sparsification, run
by :class:`~repro_torch.core.engine.SummaryEngine`.
"""

from repro_torch.core.summarize import summarize  # noqa: F401
from repro_torch.core.types import (  # noqa: F401
    Graph,
    PairTable,
    SummaryConfig,
    SummaryResult,
    SummaryState,
    init_state,
    make_graph,
    resolve_device,
)
