"""The LM stack's models, port of ``repro/models`` (the dense family so far):
building blocks, blockwise attention, the transformer and the model API."""

from repro_torch.models.api import Model, build_model  # noqa: F401
