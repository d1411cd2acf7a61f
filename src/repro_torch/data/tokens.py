"""Deterministic synthetic LM token pipeline.

The port's own copy of ``repro/data/tokens.py`` (pure numpy): its batches
equal the reference's value for value.

Text corpora are synthesized from a seeded order-1 Markov "language" with
a Zipf unigram marginal — structured enough
that a causal LM shows a real, monotone loss drop (the quickstart trains on
it), cheap enough to generate on the fly at any batch size.

Determinism contract (fault tolerance): batch ``i`` is a pure function of
``(seed, i)`` — restarting from a checkpoint at step ``s`` regenerates the
exact stream by continuing at ``i = s``, with no pipeline state to persist.
Sharding contract (elasticity): ``batch_for_rank`` slices the same global
batch by data-parallel rank, so any mesh width reproduces identical global
batches.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class TokenDatasetConfig:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0
    zipf_a: float = 1.2  # unigram skew
    markov_states: int = 64  # order-1 structure strength


class SyntheticTokens:
    """Stateless batch generator: ``batch(i) -> int32 [B, S]``."""

    def __init__(self, cfg: TokenDatasetConfig):
        self.cfg = cfg
        rng = np.random.default_rng(cfg.seed)
        m = min(cfg.markov_states, cfg.vocab)
        # sparse-support transition table over m frequent states; each state
        # prefers a few successors (gives the LM learnable structure)
        probs = rng.dirichlet(np.full(8, 0.4), size=m)
        succ = np.stack([rng.choice(m, size=8, replace=False) for _ in range(m)])
        self._succ = succ.astype(np.int64)  # [m, 8]
        self._cum = np.cumsum(probs, axis=1)  # [m, 8]
        # Zipf-ish map from the m states to the full vocab
        ranks = np.arange(1, cfg.vocab + 1, dtype=np.float64)
        w = ranks ** (-cfg.zipf_a)
        self._vocab_cum = np.cumsum(w / w.sum())
        self._state_token = rng.permutation(cfg.vocab)[:m]
        self._m = m

    def batch(self, index: int) -> np.ndarray:
        cfg = self.cfg
        rng = np.random.default_rng((cfg.seed + 1) * 1_000_003 + index)
        b, s = cfg.global_batch, cfg.seq_len
        state = rng.integers(0, self._m, size=b)
        out = np.empty((b, s), dtype=np.int64)
        u = rng.random((b, s))
        noise = rng.random((b, s)) < 0.1  # 10% unigram noise tokens
        noise_tok = np.searchsorted(self._vocab_cum, rng.random((b, s)))
        for t in range(s):
            pick = (u[:, t, None] <= self._cum[state]).argmax(axis=1)
            state = self._succ[state, pick]
            out[:, t] = self._state_token[state]
        out = np.where(noise, noise_tok, out)
        return out.astype(np.int32)

    def batch_for_rank(self, index: int, rank: int, dp: int) -> np.ndarray:
        """This rank's slice of global batch ``index`` (elastic-safe)."""
        g = self.batch(index)
        per = g.shape[0] // dp
        return g[rank * per : (rank + 1) * per]
