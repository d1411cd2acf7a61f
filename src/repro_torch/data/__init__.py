from repro_torch.data.loader import Loader
from repro_torch.data.tokens import SyntheticTokens, TokenDatasetConfig

__all__ = ["Loader", "SyntheticTokens", "TokenDatasetConfig"]
