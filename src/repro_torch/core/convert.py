"""Carry the reference's state and draws into the port.

``repro`` keeps its state in JAX arrays and draws its permutations with
threefry; the port can reproduce neither by itself. These helpers take the
reference's values as numpy arrays, so one state can be fed to both
implementations and a round compared:

  * :func:`state_from_numpy` — a reference ``SummaryState`` (its
    ``node2super``, ``size`` and ``t``) as the port's;
  * :class:`ReplayPermutations` — a permutation source that replays given
    ``(h, tie)`` pairs, one pair per round (its position, ``used``, is its
    checkpointed state);
  * :func:`group_tables_from_numpy` — a reference ``GroupTables`` as the
    port's.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.tables import GroupTables
from repro_torch.core.types import SummaryState


def state_from_numpy(node2super, size, t, device) -> SummaryState:
    return SummaryState(
        node2super=torch.as_tensor(np.array(node2super, np.int64), device=device),
        size=torch.as_tensor(np.array(size, np.int64), device=device),
        t=int(t),
    )


class ReplayPermutations:
    """Replays ``[(h, tie), ...]``, one pair per round; raises when exhausted."""

    def __init__(self, rounds):
        self.rounds = [(np.array(h, np.int64), np.array(tie, np.int64))
                       for h, tie in rounds]
        self.used = 0

    def draw(self, num_nodes, device):
        if self.used >= len(self.rounds):
            raise IndexError(f"ReplayPermutations: all {len(self.rounds)} rounds "
                             "have been drawn")
        h, tie = self.rounds[self.used]
        if h.shape != (num_nodes,) or tie.shape != (num_nodes,):
            raise ValueError(f"ReplayPermutations: round {self.used} holds "
                             f"permutations of length {h.shape[0]}, not {num_nodes}")
        self.used += 1
        return (torch.as_tensor(h, device=device), torch.as_tensor(tie, device=device))

    def state_dict(self) -> dict:
        """The number of rounds drawn so far."""
        return {"kind": "replay", "used": self.used}

    def load_state_dict(self, sd: dict) -> None:
        if sd.get("kind") != "replay":
            raise ValueError(f"ReplayPermutations cannot load the state of a "
                             f"{sd.get('kind')!r} permutation source")
        if not 0 <= sd["used"] <= len(self.rounds):
            raise ValueError(f"ReplayPermutations: position {sd['used']} is outside "
                             f"the {len(self.rounds)} rounds held")
        self.used = int(sd["used"])


def group_tables_from_numpy(m, n, s, t, n_u, cidx, w, members, device) -> GroupTables:
    def f32(x):
        return torch.as_tensor(np.array(x, np.float32), device=device)

    return GroupTables(
        m=f32(m), n=f32(n), s=f32(s), t=f32(t), n_u=f32(n_u),
        cidx=torch.as_tensor(np.array(cidx, np.int32), device=device),
        w=f32(w),
        members=torch.as_tensor(np.array(members, np.int64), device=device),
    )
