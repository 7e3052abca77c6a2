"""Deterministic synthetic token pipeline for LM training
(``repro.data.tokens``, numpy only, so its batches equal the reference's).

Each (host, step) pair derives its slice of the global batch from a
counter-based RNG: every host materializes only its rows, any host can
recompute any step (replay after a restart is exact).  A Zipf-ish unigram
plus a shifted bigram gives the loss a learnable structure.
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class TokenStream:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0
    n_hosts: int = 1
    host_id: int = 0

    @property
    def host_batch(self) -> int:
        assert self.global_batch % self.n_hosts == 0
        return self.global_batch // self.n_hosts

    def batch(self, step: int) -> dict:
        """Batch for this host at ``step`` (deterministic, replayable):
        ``tokens`` and ``labels`` [host_batch, seq_len] int32 numpy."""
        rng = np.random.default_rng(np.random.SeedSequence([self.seed, step, self.host_id]))
        b, s, v = self.host_batch, self.seq_len, self.vocab
        # zipf unigrams, then a deterministic bigram shift for structure
        ranks = rng.zipf(1.3, size=(b, s + 1)).astype(np.int64)
        toks = np.minimum(ranks, v - 1).astype(np.int32)
        toks[:, 1:] = (toks[:, 1:] + 7 * toks[:, :-1]) % v
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:].copy()}
