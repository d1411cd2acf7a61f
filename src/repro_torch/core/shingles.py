"""Candidate generation (Sect. 3.2.2): min-hash shingles → candidate groups.

Port of ``repro/core/shingles.py`` (``node_shingles``, ``supernode_shingles``,
``chunk_groups``, ``chunk_groups_lean``, ``build_groups``,
``build_groups_from_pairs``) and of the edge-sharded backend's
``_local_supernode_shingles`` (``repro/core/distributed.py:218``).
Supernodes sharing a shingle are within 2 hops; they are sorted by
``(dead, shingle, random)`` and chunked into ``[G, C]`` groups.

Randomness comes from a *permutation source*: each round draws the bijection
``h`` (``shingles.py:27`` of the reference) and the tie-break permutation
(``shingles.py:59``) from it. :class:`TorchPermutations` is the default, a
``torch.Generator`` on the run's device seeded from ``cfg.seed``.
:class:`repro_torch.core.convert.ReplayPermutations` replays given
permutations (the reference's, in the parity tests). The port cannot
reproduce JAX's threefry draws, so a run with the default source follows
another random path than the reference's run with the same seed.

A source's position is part of a run's state: ``state_dict()`` gives it as
JSON values and ``load_state_dict()`` puts it back, so a checkpointed run
resumes on the same random path (:class:`~repro_torch.core.engine.EngineCheckpointer`).

The edge-sharded backend draws by ``(round, rank)`` instead
(:class:`RoundPermutationSource`): the compact grouping draws one ``h`` a
round that every rank shares (rank 0's draw), the hash grouping one
``(h, tie)`` per round and rank. :class:`SeededPermutations` derives each
draw from ``(seed, round, rank)`` alone, so it has no position to save and a
run resumes on any number of ranks;
:class:`repro_torch.core.convert.ReplayRoundPermutations` replays the
reference's draws.
"""

from __future__ import annotations

import hashlib
from typing import Protocol

import torch

from repro_torch.core.types import SummaryState


class PermutationSource(Protocol):
    """Where a round's two permutations of ``[0, V)`` come from."""

    def draw(self, num_nodes: int, device: torch.device
             ) -> tuple[torch.Tensor, torch.Tensor]:
        """``(h, tie)``: two int64 permutations on ``device``."""
        ...

    def state_dict(self) -> dict:
        """The source's position, as JSON values."""
        ...

    def load_state_dict(self, sd: dict) -> None:
        """Continue from a position that :meth:`state_dict` gave."""
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

    def state_dict(self) -> dict:
        """The generator's ``get_state()`` bytes (uint8 values) and device type."""
        return {"kind": "torch", "device_type": self.device.type,
                "state": self.generator.get_state().tolist()}

    def load_state_dict(self, sd: dict) -> None:
        """Set the generator's state; a state of another kind of source or
        another device type raises (a CUDA generator's state cannot seed a CPU
        generator, and the source never reseeds in its place)."""
        if sd.get("kind") != "torch":
            raise ValueError(f"TorchPermutations cannot load the state of a "
                             f"{sd.get('kind')!r} permutation source")
        if sd.get("device_type") != self.device.type:
            raise ValueError(
                f"permutation state was saved by a generator on "
                f"{sd.get('device_type')!r}; this run's generator is on "
                f"{self.device.type!r}. Resume on the device the run was "
                "checkpointed on.")
        self.generator.set_state(torch.tensor(sd["state"], dtype=torch.uint8))


class RoundPermutationSource(Protocol):
    """Where the edge-sharded backend's permutations come from."""

    def draw_at(self, num_nodes: int, device: torch.device, round: int, rank: int
                ) -> tuple[torch.Tensor, torch.Tensor]:
        """``(h, tie)`` of round ``round`` (1-based) on rank ``rank``: two
        int64 permutations of ``[0, num_nodes)`` on ``device``."""
        ...

    def state_dict(self) -> dict:
        ...

    def load_state_dict(self, sd: dict) -> None:
        ...


class SeededPermutations:
    """``torch.randperm`` from a generator seeded from ``(seed, round, rank)``.

    Each draw depends on its three numbers alone (a BLAKE2 digest of them is
    the generator's seed), so the source keeps no position: a resume, on any
    number of ranks, draws what an uninterrupted run draws.
    """

    def __init__(self, seed: int, device: str | torch.device):
        self.seed = int(seed)
        self.device = torch.device(device)

    def _generator(self, round: int, rank: int) -> torch.Generator:
        key = f"{self.seed}:{int(round)}:{int(rank)}".encode()
        mixed = int.from_bytes(hashlib.blake2b(key, digest_size=8).digest(), "little")
        gen = torch.Generator(device=self.device)
        gen.manual_seed(mixed >> 1)  # below 2**63
        return gen

    def draw_at(self, num_nodes, device, round, rank):
        gen = self._generator(round, rank)
        h = torch.randperm(num_nodes, generator=gen, device=self.device)
        tie = torch.randperm(num_nodes, generator=gen, device=self.device)
        return h.to(device), tie.to(device)

    def state_dict(self) -> dict:
        return {"kind": "seeded", "seed": self.seed, "device_type": self.device.type}

    def load_state_dict(self, sd: dict) -> None:
        """Checks that the saved run drew as this source draws: the same kind,
        seed and device type (a CUDA generator's stream is not a CPU one's)."""
        want = self.state_dict()
        if {k: sd.get(k) for k in want} != want:
            raise ValueError(f"SeededPermutations {want} cannot continue a run that "
                             f"drew from {sd}")


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


def chunk_groups_lean(shingle: torch.Tensor, group_size: int) -> torch.Tensor:
    """The 2-key variant of :func:`chunk_groups`: sort by (shingle, id).

    The shingles must already carry the dead sentinel ``V`` (what
    :func:`supernode_shingles` and :func:`local_supernode_shingles` give), so
    the dead key is redundant; id order breaks ties, which a stable sort of
    the shingles keeps.
    """
    num_nodes = shingle.shape[0]
    order = torch.sort(shingle, stable=True).indices
    pad = (-num_nodes) % group_size
    if pad:
        order = torch.cat([order, torch.full((pad,), -1, dtype=torch.int64,
                                             device=order.device)])
    return order.reshape(-1, group_size)


def build_groups_from_pairs(plo: torch.Tensor, phi: torch.Tensor, pvalid: torch.Tensor,
                            size: torch.Tensor, h: torch.Tensor, tie: torch.Tensor,
                            group_size: int) -> torch.Tensor:
    """Candidate groups from *supergraph-level* shingles (the hash-owner path).

    An owner rank holds the whole superedge adjacency of its supernodes, so
    ``f(A) = min(h(A), min_{{A,B}∈P} h(B))`` is exact there. ``size`` is
    zero for supernodes the rank does not own, which sorts them last.
    """
    num_nodes = size.shape[0]
    ok = pvalid & (plo != phi)
    f = torch.cat([h, h.new_full((1,), num_nodes)])  # slot V: the sentinel
    sent = torch.full_like(plo, num_nodes)
    f.scatter_reduce_(0, torch.where(ok, plo, sent),
                      torch.where(ok, h[torch.clamp(phi, max=num_nodes - 1)], sent),
                      reduce="amin", include_self=True)
    f.scatter_reduce_(0, torch.where(ok, phi, sent),
                      torch.where(ok, h[torch.clamp(plo, max=num_nodes - 1)], sent),
                      reduce="amin", include_self=True)
    return chunk_groups(f[:num_nodes], size, tie, group_size)


def local_supernode_shingles(src_l: torch.Tensor, dst_l: torch.Tensor,
                             node2super: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
    """Per-supernode min-hash from one rank's edge shard (``-1`` rows are
    padding). The minimum over ranks (``all_reduce(MIN)``) is
    :func:`supernode_shingles` of the whole edge list; dead ids keep ``V``."""
    num_nodes = h.shape[0]
    pad = src_l < 0
    s_safe = torch.clamp(src_l, min=0)
    d_safe = torch.clamp(dst_l, min=0)
    sent = torch.full_like(src_l, num_nodes)
    f = torch.cat([h, h.new_full((1,), num_nodes)])  # closed neighborhood; slot V
    f.scatter_reduce_(0, torch.where(pad, sent, s_safe),
                      torch.where(pad, sent, h[d_safe]), reduce="amin", include_self=True)
    f.scatter_reduce_(0, torch.where(pad, sent, d_safe),
                      torch.where(pad, sent, h[s_safe]), reduce="amin", include_self=True)
    out = torch.full((num_nodes,), num_nodes, dtype=torch.int64, device=h.device)
    return out.scatter_reduce_(0, node2super, f[:num_nodes], reduce="amin",
                               include_self=True)
