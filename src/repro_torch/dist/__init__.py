"""repro_torch.dist — the supernode ownership hash, the payload codecs and
microbatched gradient accumulation.

Port of the summarization part of ``repro/dist/sharding.py``, of
``repro/dist/compress.py`` and of ``repro/dist/microbatch.py``. The port
keeps no mesh: a flat ``torch.distributed`` group of P ranks takes the
reference's ``summarize``-mode layout, in which edges are split over every
mesh axis.
"""

from repro_torch.dist.compress import (  # noqa: F401
    CompressConfig,
    compressed_all_reduce,
    decode_int8,
    encode_int8,
    encode_topk,
    init_error_buffers,
    payload_bytes,
)
from repro_torch.dist.microbatch import microbatch_grads, value_and_grad  # noqa: F401
from repro_torch.dist.sharding import OWNER_HASH_MULT, owner_hash  # noqa: F401
