"""Training losses: causal LM cross-entropy (float32, z-loss) + MoE aux.

Port of ``repro/models/losses.py``. The metrics come back detached.
"""

from __future__ import annotations

import torch


def causal_lm_loss(logits, tokens, *, z_loss: float = 1e-4, moe_aux=None,
                   moe_aux_weight: float = 1e-2, prefix_len: int = 0):
    """Next-token prediction: logits[:, t] predicts tokens[:, t+1].

    ``prefix_len``: number of leading positions (image/audio prefix) whose
    predictions are not scored. Returns ``(total, {"nll", "ppl_proxy"})``.
    """
    lg = logits[:, prefix_len:-1].float()
    tg = tokens[:, 1:].long()
    lse = torch.logsumexp(lg, dim=-1)
    ll = torch.gather(lg, -1, tg[..., None])[..., 0]
    nll = torch.mean(lse - ll)
    total = nll
    if z_loss:
        total = total + z_loss * torch.mean(lse ** 2)
    if moe_aux is not None:
        total = total + moe_aux_weight * moe_aux
    nll = nll.detach()
    return total, {"nll": nll, "ppl_proxy": torch.exp(torch.clamp(nll, max=20.0))}


def seq2seq_loss(logits, tokens, **kw):
    return causal_lm_loss(logits, tokens, **kw)
