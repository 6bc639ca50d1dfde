"""Deterministic batching iterators for the production LM training driver.

Synthetic token streams (Markov chains) stand in for a real corpus; the
iterator yields {tokens, labels} with labels = tokens (the loss shifts
internally). PRNG streams are derived per (epoch, step) so any batch is
reproducible without global state.
"""
from __future__ import annotations

import numpy as np

from repro_torch.data.synthetic import make_lm_stream


class TokenBatcher:
    def __init__(self, vocab: int, seq_len: int, batch: int, seed: int = 0):
        self.vocab = vocab
        self.seq_len = seq_len
        self.batch = batch
        self.seed = seed

    def batch_at(self, step: int):
        rng = np.random.default_rng((self.seed, step))
        toks = make_lm_stream(self.batch, self.seq_len,
                              min(self.vocab, 512), rng)
        return {"tokens": toks.astype(np.int32),
                "labels": toks.astype(np.int32)}

    def __iter__(self):
        step = 0
        while True:
            yield self.batch_at(step)
            step += 1
