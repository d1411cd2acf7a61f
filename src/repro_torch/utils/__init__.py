from repro_torch.utils.segments import (  # noqa: F401
    boundaries_from_keys,
    rank_in_segment,
    segment_ids_from_boundaries,
    segment_start,
)
