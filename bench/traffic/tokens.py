"""The LLM cells' batches: token ids from a noisy affine Markov chain over
the vocabulary, the recipe of the repository's synthetic stream (each
token the last one times an odd multiplier plus an offset, modulo the
vocabulary, or with probability `noise` a uniform draw), generated here a
step at a time from the seed.

Every batch is (B, S) tokens and the (B, S) next tokens as labels, all
positions counted: the same work for every seed.
"""
from __future__ import annotations

from typing import Iterator

import numpy as np


def lm_stream(vocab: int, batch: int, seq: int, *, seed: int,
              noise: float) -> Iterator[dict]:
    rng = np.random.default_rng(seed)
    a = int(rng.integers(3, 17)) | 1
    b = int(rng.integers(1, vocab))
    last = int(rng.integers(0, vocab))
    n = batch * (seq + 1)
    while True:
        rand = rng.integers(0, vocab, size=n)
        use = rng.random(n) < noise
        toks = np.empty(n, np.int32)
        for i in range(n):
            last = int(rand[i]) if use[i] else (a * last + b) % vocab
            toks[i] = last
        x = toks.reshape(batch, seq + 1)
        yield {"tokens": x[:, :-1], "labels": x[:, 1:]}
