"""Synthetic token streams for LLM smoke training / examples.

The stream has learnable first-order structure (a noisy affine Markov chain
over the vocab) so a few hundred training steps visibly reduce loss — the
end-to-end driver (examples/train_llm.py) relies on this.

Reference: src/repro/data/tokens.py (`markov_stream`, copied; `lm_batches`
comes with the LLM training slice).
"""
from __future__ import annotations

import numpy as np


def markov_stream(vocab_size: int, n_tokens: int, *, seed: int = 0,
                  noise: float = 0.2) -> np.ndarray:
    rng = np.random.default_rng(seed)
    a = int(rng.integers(3, 17)) | 1                  # odd multiplier
    b = int(rng.integers(1, vocab_size))
    toks = np.empty(n_tokens, np.int32)
    toks[0] = rng.integers(0, vocab_size)
    rand = rng.integers(0, vocab_size, size=n_tokens)
    use_rand = rng.random(n_tokens) < noise
    for t in range(1, n_tokens):
        toks[t] = rand[t] if use_rand[t] else (a * int(toks[t - 1]) + b) % vocab_size
    return toks
