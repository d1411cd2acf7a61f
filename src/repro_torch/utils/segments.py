"""Segment helpers for sorted-key dataflow.

Port of ``repro/utils/segments.py``. Every helper works on a *sorted* 1-D key
layout with a fixed shape, so a round of the algorithm never needs the host
to learn how many segments there are.
"""

from __future__ import annotations

import torch


def segment_start(is_new: torch.Tensor) -> torch.Tensor:
    """Index of the first element of each element's segment.

    ``is_new[i]`` is True when element ``i`` opens a segment (element 0 must).
    The reference takes a running maximum; ``torch.cummax`` is a slow scan on
    CUDA (65 ms over 22 M elements on an H100), so each segment's start is
    scattered to its segment id instead and gathered back.
    """
    n = is_new.shape[0]
    idx = torch.arange(n, device=is_new.device)
    seg = segment_ids_from_boundaries(is_new)
    first = torch.zeros(n + 1, dtype=torch.int64, device=is_new.device)
    first.scatter_(0, torch.where(is_new, seg, n), idx)  # slot n: discarded
    return first[seg]


def rank_in_segment(is_new: torch.Tensor) -> torch.Tensor:
    """0-based rank of each element within its segment (int64)."""
    idx = torch.arange(is_new.shape[0], device=is_new.device)
    return idx - segment_start(is_new)


def boundaries_from_keys(*keys: torch.Tensor) -> torch.Tensor:
    """``is_new`` flags for a lexicographically sorted multi-key array."""
    new = torch.zeros(keys[0].shape[0], dtype=torch.bool, device=keys[0].device)
    new[0] = True
    for k in keys:
        new[1:] |= k[1:] != k[:-1]
    return new


def segment_ids_from_boundaries(is_new: torch.Tensor) -> torch.Tensor:
    """Contiguous 0-based segment ids (int64) from ``is_new`` flags."""
    return torch.cumsum(is_new.to(torch.int64), dim=0) - 1
