"""Supernode ownership for the edge-sharded backend.

Port of ``repro/dist/sharding.py``'s ``owner_hash_np`` and ``MeshRules.owner``.
In ``"summarize"`` mode the reference splits the edge dimension over every
mesh axis (``MeshRules.edge_spec``), so device ``d``'s shard is the ``d``-th
contiguous block, where ``d`` is ``jax.lax.axis_index`` over all axes. A flat
group of P ranks has the same layout with rank ``r`` in place of ``d``.
"""

from __future__ import annotations

import torch

# Knuth's multiplicative constant, the reference's OWNER_HASH_MULT.
OWNER_HASH_MULT = 2654435761
_U32 = 0xFFFFFFFF


def owner_hash(ids: torch.Tensor, salt: int, n_ranks: int) -> torch.Tensor:
    """Rank owning supernode ``ids`` for this round's ``salt``, int64.

    The reference's uint32 arithmetic, ``x = (id·MULT mod 2³²) ^ salt;
    x ^= x >> 16; x mod P``, carried out in int64 with explicit wrap-around.
    """
    x = ((ids.to(torch.int64) & _U32) * OWNER_HASH_MULT) & _U32
    x = x ^ (int(salt) & _U32)
    x = (x >> 16) ^ x
    return x % max(1, int(n_ranks))
