"""The comparison's controls: answers the check has to refuse.

* ``bfloat16``: the reference put in the program's place and computed one
  precision below the configuration's float32: the summary's Size, RE₁ and
  RE₂, the round's Cost*_A totals and C̄, the pair costs and the merge gains,
  all in bfloat16 on the same partition and operands.
* ``node_moved``: one subnode of a kept superedge moved to another live
  supernode, the sizes kept consistent (that superedge's weight then
  miscounts).
* ``weight_changed``: one superedge's weight one more than its count.

Each returns the summary and the round as the program would have returned
them; :func:`bench.reference.check.judge` then reads them.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from bench.reference import check, kernels, summary

BF16 = torch.bfloat16


def bfloat16(src, dst, num_nodes: int, out: check.Summary, cap: check.Capture
             ) -> tuple[check.Summary, check.Capture]:
    v = num_nodes
    n2s = torch.from_numpy(out.node2super).long()
    size = summary.sizes(n2s, v)
    lo, hi, cnt = summary.pair_table(src, dst, n2s, v)
    key = lo * v + hi
    ekey = torch.from_numpy(out.edge_lo).long() * v + torch.from_numpy(out.edge_hi).long()
    kept = torch.zeros(key.numel(), dtype=torch.bool)
    kept[torch.searchsorted(key, ekey)] = True
    pi = summary.pair_pi(lo, hi, size)
    low = summary.summary_metrics(v, int((size > 0).sum()), cnt[kept], pi[kept],
                                  cnt[~kept], BF16)
    out = dataclasses.replace(out, **{k: float(x) for k, x in low.items()})

    ref = check.round_reference(src, dst, v, cap.n2s_before, dtype=BF16)
    mid = torch.from_numpy(cap.members).long().clamp(0, v - 1)
    live = torch.from_numpy(cap.n) > 0
    t = torch.where(live, ref.totals[mid].float(), 0.0)
    rows = torch.from_numpy(cap.rows).long()
    inside = rows < ref.cnt.numel()
    r_in = rows.clamp(max=ref.cnt.numel() - 1)
    pc = torch.where(inside, kernels.pair_cost(ref.cnt[r_in].to(BF16), ref.pi[r_in].to(BF16),
                                               ref.cbar, ref.log2v), 0.0)
    operands = [torch.from_numpy(x).to(BF16) for x in (cap.m, cap.n, cap.s, cap.t, cap.n_u)]
    scal = torch.from_numpy(cap.scal).to(BF16)
    rel, red, _ = kernels.merge_gain(*operands, torch.from_numpy(cap.cidx),
                                     torch.from_numpy(cap.w).to(BF16), scal[0], scal[1])
    cap = dataclasses.replace(
        cap, t=t.numpy(), pc_out=pc.float().numpy(), rel=rel.float().numpy(),
        red=red.float().numpy(),
        scal=np.array([float(ref.cbar), float(ref.log2v)], dtype=np.float32))
    return out, cap


def node_moved(src, dst, out: check.Summary, seed: int = 0) -> check.Summary:
    """One subnode moved to another live supernode, the sizes kept
    consistent: an end ``u`` of an input edge inside a kept superedge
    ``{A, C}``, moved to a supernode other than ``A`` and ``C``, so that
    superedge's count changes. (A move between two supernodes that no kept
    superedge touches would leave an equally valid summary.)"""
    rng = np.random.default_rng(seed)
    src, dst = np.asarray(src), np.asarray(dst)
    n2s = out.node2super.astype(np.int64)
    size = out.super_size.copy()
    v = n2s.size
    su, sv = n2s[src], n2s[dst]
    kept = out.edge_lo.astype(np.int64) * v + out.edge_hi
    inside = (su != sv) & np.isin(np.minimum(su, sv) * v + np.maximum(su, sv), kept)
    i = int(rng.choice(np.flatnonzero(inside)))
    x, a, c = int(src[i]), int(su[i]), int(sv[i])
    others = np.flatnonzero(size > 0)
    y = int(rng.choice(others[(others != a) & (others != c)]))
    n2s = out.node2super.copy()
    size[a] -= 1
    size[y] += 1
    n2s[x] = y
    return dataclasses.replace(out, node2super=n2s, super_size=size,
                               num_supernodes=int((size > 0).sum()))


def weight_changed(out: check.Summary, seed: int = 0) -> check.Summary:
    """One superedge's weight one more than its count."""
    w = out.edge_w.copy()
    w[np.random.default_rng(seed).integers(w.size)] += 1
    return dataclasses.replace(out, edge_w=w)
