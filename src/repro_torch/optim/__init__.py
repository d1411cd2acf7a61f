"""repro_torch.optim — AdamW with global-norm clipping and a cosine schedule
(port of ``repro/optim``)."""

from repro_torch.optim.adamw import (  # noqa: F401
    AdamWState,
    adamw_init,
    adamw_update,
    cosine_schedule,
    global_norm,
)
