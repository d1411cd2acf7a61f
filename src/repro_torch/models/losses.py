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
    return lm_total(lse, ll, z_loss=z_loss, moe_aux=moe_aux, moe_aux_weight=moe_aux_weight)


def sum_exp(lg, mx):
    """A vocab part's ``Σ exp(lg - mx)`` over its last dimension."""
    return torch.sum(torch.exp(lg - mx[..., None]), dim=-1)


def target_logit(lg, tg, start: int):
    """The target's logit where it lies in this part (vocab ids ``[start,
    start + part)``), else 0."""
    n = lg.shape[-1]
    local = tg - start
    hit = (local >= 0) & (local < n)
    got = torch.gather(lg, -1, torch.clamp(local, 0, n - 1)[..., None])[..., 0]
    return torch.where(hit, got, torch.zeros((), dtype=lg.dtype, device=lg.device))


def causal_lm_loss_parallel(logits, tokens, tp, *, z_loss: float = 1e-4, moe_aux=None,
                            moe_aux_weight: float = 1e-2, prefix_len: int = 0):
    """:func:`causal_lm_loss` of vocab-sharded logits: ``logits`` is model
    rank ``tp.rank``'s part ``[B, S, V/M]`` of the vocab (a
    :class:`~repro_torch.dist.tensor_parallel.TensorParallel` of M ranks).
    The logsumexp takes the max over the parts, then the sum of ``exp`` over
    them; the target logit comes from the part that holds it. Every rank
    returns the same loss."""
    lg = logits[:, prefix_len:-1].float()
    tg = tokens[:, 1:].long()
    mx = tp.max(lg.amax(dim=-1))
    lse = mx + torch.log(tp.reduce(sum_exp(lg, mx)))
    ll = tp.reduce(target_logit(lg, tg, tp.part(tp.size * lg.shape[-1])[0]))
    return lm_total(lse, ll, z_loss=z_loss, moe_aux=moe_aux, moe_aux_weight=moe_aux_weight)


def lm_total(lse, ll, *, z_loss: float = 1e-4, moe_aux=None, moe_aux_weight: float = 1e-2):
    """The loss from each position's logsumexp and target logit: the mean
    NLL, the z-loss and the MoE aux term; ``(total, metrics)``."""
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
