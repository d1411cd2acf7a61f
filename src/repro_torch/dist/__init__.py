"""repro_torch.dist — the supernode ownership hash of the edge-sharded backend.

Port of the summarization part of ``repro/dist/sharding.py``. The port keeps
no mesh: a flat ``torch.distributed`` group of P ranks takes the reference's
``summarize``-mode layout, in which edges are split over every mesh axis.
"""

from repro_torch.dist.sharding import OWNER_HASH_MULT, owner_hash  # noqa: F401
