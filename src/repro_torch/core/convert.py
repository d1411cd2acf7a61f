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
  * :class:`ReplayRoundPermutations` — the edge-sharded backend's source
    that replays the reference's draws by round and rank;
  * :func:`group_tables_from_numpy` — a reference ``GroupTables`` as the
    port's;
  * :func:`tree_from_numpy` — a reference pytree of numpy arrays (bfloat16
    leaves included) as the port's tree of tensors, in jax's flatten order;
  * :func:`lm_params_from_numpy` — a reference LM parameter tree (the values
    of ``split_tree``, as numpy arrays) as the port's, checked leaf for leaf
    against the shapes the port's model takes.
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


class ReplayRoundPermutations:
    """Replays given draws by ``(round, rank)``: ``h[round - 1][rank]`` and
    ``tie[round - 1][rank]``. ``tie`` may be None (the compact grouping with
    the lean sort uses no tie); a draw then gives None for it. A 2-D ``h``
    (one row a round) serves every rank, as the compact grouping's draw
    does. Keeps no position."""

    def __init__(self, h, tie=None):
        self.h = np.asarray(h, np.int64)
        self.tie = None if tie is None else np.asarray(tie, np.int64)

    def _pick(self, table, round, rank):
        if round < 1 or round > table.shape[0]:
            raise IndexError(f"ReplayRoundPermutations holds rounds 1..{table.shape[0]}, "
                             f"not {round}")
        row = table[round - 1]
        return row if row.ndim == 1 else row[rank]

    def draw_at(self, num_nodes, device, round, rank):
        h = self._pick(self.h, round, rank)
        tie = None if self.tie is None else self._pick(self.tie, round, rank)
        if h.shape != (num_nodes,) or (tie is not None and tie.shape != (num_nodes,)):
            raise ValueError(f"ReplayRoundPermutations: round {round} holds permutations "
                             f"of length {h.shape[0]}, not {num_nodes}")
        return (torch.as_tensor(h, device=device),
                None if tie is None else torch.as_tensor(tie, device=device))

    def state_dict(self) -> dict:
        return {"kind": "replay-rounds"}

    def load_state_dict(self, sd: dict) -> None:
        if sd.get("kind") != "replay-rounds":
            raise ValueError(f"ReplayRoundPermutations cannot load the state of a "
                             f"{sd.get('kind')!r} permutation source")


def group_tables_from_numpy(m, n, s, t, n_u, cidx, w, members, device) -> GroupTables:
    def f32(x):
        return torch.as_tensor(np.array(x, np.float32), device=device)

    return GroupTables(
        m=f32(m), n=f32(n), s=f32(s), t=f32(t), n_u=f32(n_u),
        cidx=torch.as_tensor(np.array(cidx, np.int32), device=device),
        w=f32(w),
        members=torch.as_tensor(np.array(members, np.int64), device=device),
    )


def _tensor_from_numpy(a, device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":  # ml_dtypes' bfloat16: no numpy counterpart in torch
        return torch.from_numpy(np.array(a).view(np.int16)).view(torch.bfloat16).to(device)
    return torch.as_tensor(np.array(a), device=device)


def tree_from_numpy(tree, device):
    """A reference pytree of numpy arrays as the port's tree of tensors on
    ``device``: dicts rebuilt with their keys sorted (jax's flatten order,
    the order the port's codecs walk), lists and tuples kept, ``None`` kept."""
    if isinstance(tree, dict):
        return {k: tree_from_numpy(tree[k], device) for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_from_numpy(x, device) for x in tree)
    return None if tree is None else _tensor_from_numpy(tree, device)


def lm_params_from_numpy(tree, cfg, device):
    """The reference's LM parameters (``split_tree(model.init_px(key))[0]``
    as numpy arrays) as the port's parameter tree on ``device``, each leaf in
    its own type (an MoE router and the norms stay float32 in a bfloat16
    model). Dense and MoE trees alike. Raises on a missing or extra leaf or a
    shape the port's model for ``cfg`` does not take."""
    from repro_torch.models.transformer import param_shapes

    def walk(node, want, path):
        if isinstance(want, dict):
            if not isinstance(node, dict) or set(node) != set(want):
                got = sorted(node) if isinstance(node, dict) else type(node).__name__
                raise ValueError(f"lm_params_from_numpy: {path or 'the tree'} holds {got}, "
                                 f"the port's {cfg.name} takes {sorted(want)}")
            return {k: walk(node[k], want[k], f"{path}/{k}") for k in want}
        if tuple(np.shape(node)) != tuple(want):
            raise ValueError(f"lm_params_from_numpy: {path} has shape {np.shape(node)}, "
                             f"the port's {cfg.name} takes {tuple(want)}")
        return _tensor_from_numpy(node, device)

    return walk(tree, param_shapes(cfg), "")
