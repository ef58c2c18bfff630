"""Synthetic token streams for LLM smoke training / examples.

The stream has learnable first-order structure (a noisy affine Markov chain
over the vocab) so a few hundred training steps visibly reduce loss — the
end-to-end driver (examples/train_llm.py) relies on this.

Reference: src/repro/data/tokens.py (`markov_stream`, `lm_batches`,
copied).  The batches are numpy arrays, int32 ids as the reference's; the
launcher (launch/train.py) moves them to the device as int64 tensors.
"""
from __future__ import annotations

from typing import Iterator

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


def lm_batches(cfg, batch_size: int, seq_len: int, *, steps: int,
               seed: int = 0) -> Iterator[dict]:
    """Yields batch dicts matching repro_torch.models.zoo input conventions:
    text {"tokens", "labels"}; audio {"tokens_mc", "labels"}, codebook i
    offset by 7 i; VLM {"patch_embeds" N(0, 1) from default_rng(seed + 1),
    "tokens", "labels" -1 over the patch prefix}."""
    stream = markov_stream(cfg.vocab_size,
                           batch_size * (seq_len + 1) * max(steps, 1) + 1,
                           seed=seed)
    rng = np.random.default_rng(seed + 1)
    per = batch_size * (seq_len + 1)
    for s in range(steps):
        chunk = stream[s * per:(s + 1) * per + 1]
        x = chunk[:per].reshape(batch_size, seq_len + 1)
        tokens, labels = x[:, :-1], x[:, 1:].astype(np.int32)
        if cfg.modality == "audio_tokens":
            k = cfg.num_codebooks
            mc = np.stack([(tokens + i * 7) % cfg.vocab_size
                           for i in range(k)], axis=-1).astype(np.int32)
            lab = np.stack([(labels + i * 7) % cfg.vocab_size
                            for i in range(k)], axis=-1).astype(np.int32)
            yield {"tokens_mc": mc, "labels": lab}
        elif cfg.modality == "vlm":
            P = cfg.num_prefix_tokens
            patches = rng.normal(size=(batch_size, P, cfg.d_model)) \
                .astype(np.float32)
            lab = np.concatenate(
                [np.full((batch_size, P), -1, np.int32), labels], axis=1)
            yield {"patch_embeds": patches, "tokens": tokens, "labels": lab}
        else:
            yield {"tokens": tokens, "labels": labels}
