from repro_torch.graphs.synthetic import DATASETS, generate  # noqa: F401
from repro_torch.graphs.io import (  # noqa: F401
    IngestStats,
    LoadedGraph,
    ingest_edge_list,
    load_graph,
    open_csr,
    write_edge_list,
)
