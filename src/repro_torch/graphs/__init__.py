from repro_torch.graphs.synthetic import DATASETS, generate  # noqa: F401
