"""Candidate generation (Sect. 3.2.2): min-hash shingles → candidate groups.

Port of ``repro/core/shingles.py`` (``node_shingles``, ``supernode_shingles``,
``chunk_groups``, ``build_groups``). Supernodes sharing a shingle are within
2 hops; they are sorted by ``(dead, shingle, random)`` and chunked into
``[G, C]`` groups.

Randomness comes from a *permutation source*: each round draws the bijection
``h`` (``shingles.py:27`` of the reference) and the tie-break permutation
(``shingles.py:59``) from it. :class:`TorchPermutations` is the default, a
``torch.Generator`` on the run's device seeded from ``cfg.seed``.
:class:`repro_torch.core.convert.ReplayPermutations` replays given
permutations (the reference's, in the parity tests). The port cannot
reproduce JAX's threefry draws, so a run with the default source follows
another random path than the reference's run with the same seed.
"""

from __future__ import annotations

from typing import Protocol

import torch

from repro_torch.core.types import SummaryState


class PermutationSource(Protocol):
    """Where a round's two permutations of ``[0, V)`` come from."""

    def draw(self, num_nodes: int, device: torch.device
             ) -> tuple[torch.Tensor, torch.Tensor]:
        """``(h, tie)``: two int64 permutations on ``device``."""
        ...


class TorchPermutations:
    """``torch.randperm`` from a generator on the run's device."""

    def __init__(self, seed: int, device: str | torch.device):
        self.device = torch.device(device)
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(int(seed))

    def draw(self, num_nodes, device):
        h = torch.randperm(num_nodes, generator=self.generator, device=self.device)
        tie = torch.randperm(num_nodes, generator=self.generator, device=self.device)
        return h.to(device), tie.to(device)


def node_shingles(src: torch.Tensor, dst: torch.Tensor,
                  h: torch.Tensor) -> torch.Tensor:
    """Per-subnode ``min(h(u), min_{(u,v)∈E} h(v))`` for the bijection ``h``."""
    f = h.clone()  # include h(u) itself (closed neighborhood)
    f.scatter_reduce_(0, src, h[dst], reduce="amin", include_self=True)
    f.scatter_reduce_(0, dst, h[src], reduce="amin", include_self=True)
    return f


def supernode_shingles(src, dst, state: SummaryState, h) -> torch.Tensor:
    """``f(A) = min_{u∈A} node_shingle(u)``; dead ids keep the sentinel ``V``."""
    num_nodes = state.node2super.shape[0]
    nf = node_shingles(src, dst, h)
    out = torch.full((num_nodes,), num_nodes, dtype=torch.int64, device=h.device)
    return out.scatter_reduce_(0, state.node2super, nf, reduce="amin",
                               include_self=True)


def chunk_groups(shingle: torch.Tensor, size: torch.Tensor, tie: torch.Tensor,
                 group_size: int) -> torch.Tensor:
    """Sort supernodes by (dead, shingle, tie) and chunk into ``[G, C]``.

    The reference sorts three int32 keys; ``tie`` is a permutation, so the
    keys are distinct and one composite int64 key
    ``(dead·(V+1) + shingle)·V + tie`` (shingle ≤ V) gives the same order.
    ``V`` is padded to a multiple of ``C`` with the id ``-1``.
    """
    num_nodes = shingle.shape[0]
    dead = (size <= 0).to(torch.int64)
    key = (dead * (num_nodes + 1) + shingle) * num_nodes + tie
    order = torch.sort(key).indices
    pad = (-num_nodes) % group_size
    if pad:
        order = torch.cat([order, torch.full((pad,), -1, dtype=torch.int64,
                                             device=order.device)])
    return order.reshape(-1, group_size)


def build_groups(src, dst, state: SummaryState, perms: PermutationSource,
                 group_size: int) -> torch.Tensor:
    """Candidate groups from subnode-level shingles (single-device path);
    draws this round's ``(h, tie)`` from ``perms``."""
    num_nodes = state.node2super.shape[0]
    h, tie = perms.draw(num_nodes, state.node2super.device)
    sh = supernode_shingles(src, dst, state, h)
    return chunk_groups(sh, state.size, tie, group_size)
