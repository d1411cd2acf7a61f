"""Blockwise (flash-style) attention in plain PyTorch for long sequences.

Port of ``repro/models/flash.py``: the online-softmax block scan with the
reference's block sizes and arithmetic, an outer loop over query blocks and
an inner loop over KV blocks carrying (running max, denominator,
accumulator), so peak live memory is one ``[B, heads, q_block, kv_block]``
score tile. Scores and the accumulator are float32. All blocks are
computed and masked (no causal skipping), as in the reference. This is
plain tensor code, not a kernel: the reference has no Pallas attention.
The KV loop's trips differ only in the positions they mask; a step's cost
count on ``meta`` without gradients runs one (``kernels/ops.py::trips``).
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels.ops import trips

NEG_INF = -1e30


def _fit_block(n: int, want: int) -> int:
    """Largest divisor of ``n`` that is ≤ ``want`` (sequences like whisper's
    1500 frames don't divide the default power-of-two blocks)."""
    if n <= want:
        return n
    if n % want == 0:
        return want
    return max(d for d in range(1, want + 1) if n % d == 0)


def blockwise_attention(
    q,  # [B, S, H, hd]
    k,  # [B, T, K, hd]
    v,  # [B, T, K, hd]
    *,
    causal: bool = True,
    window: int | None = None,
    q_block: int = 256,
    kv_block: int = 1024,
    q_offset: int = 0,  # position of q[0] (prefill continuation)
) -> torch.Tensor:
    b, s, h, hd = q.shape
    t, kk = k.shape[1], k.shape[2]
    g = h // kk
    qb = _fit_block(s, q_block)
    kb = _fit_block(t, kv_block)
    nq, nk = s // qb, t // kb
    dev = q.device

    scale = float(np.float32(1.0) / np.sqrt(np.float32(hd)))  # float32, as the reference
    q_r = q.reshape(b, nq, qb, kk, g, hd)
    k_r = k.reshape(b, nk, kb, kk, hd)
    v_r = v.reshape(b, nk, kb, kk, hd)
    outs = []
    for iq in range(nq):
        q_blk = q_r[:, iq]  # [B, qb, K, g, hd]
        pos_q = q_offset + iq * qb + torch.arange(qb, device=dev)
        m = torch.full((b, kk, g, qb), NEG_INF, dtype=torch.float32, device=dev)
        l = torch.zeros((b, kk, g, qb), dtype=torch.float32, device=dev)
        acc = torch.zeros((b, kk, g, qb, hd), dtype=torch.float32, device=dev)
        for jk in trips(nk, q, k, v):
            k_blk, v_blk = k_r[:, jk], v_r[:, jk]
            pos_k = jk * kb + torch.arange(kb, device=dev)
            s_blk = torch.einsum("bqkgx,btkx->bkgqt", q_blk, k_blk).float() * scale
            mask = torch.ones((qb, kb), dtype=torch.bool, device=dev)
            if causal:
                mask &= pos_q[:, None] >= pos_k[None, :]
            if window is not None:
                mask &= (pos_q[:, None] - pos_k[None, :]) < window
            s_blk = torch.where(mask, s_blk, torch.tensor(NEG_INF, device=dev))
            m_new = torch.maximum(m, s_blk.amax(dim=-1))
            p = torch.exp(s_blk - m_new[..., None])
            alpha = torch.exp(m - m_new)
            l = l * alpha + p.sum(dim=-1)
            acc = acc * alpha[..., None] + torch.einsum("bkgqt,btkx->bkgqx", p, v_blk.float())
            m = m_new
        out = acc / torch.clamp_min(l, 1e-30)[..., None]  # [B, K, g, qb, hd]
        outs.append(out.permute(0, 3, 1, 2, 4).reshape(b, qb, h, hd).to(q.dtype))
    return torch.cat(outs, dim=1)
