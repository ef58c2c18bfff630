"""Step functions: prefill and decode, the units the serving driver runs.

Reference: src/repro/launch/steps.py (`make_prefill_step`,
`make_decode_step`).  PyTorch runs them eagerly, under `torch.no_grad`;
the train steps come with the LLM training slice (ROADMAP queue 1, item 6).
"""
from __future__ import annotations

import torch

from repro_torch.models import zoo


def make_prefill_step(cfg):
    """(params, batch) -> (last_logits (B, V), cache)."""
    @torch.no_grad()
    def prefill_step(params, batch):
        logits, cache = zoo.forward(params, cfg, batch, mode="prefill",
                                    logits_positions="last")
        return logits[:, -1], cache
    return prefill_step


def make_decode_step(cfg, *, greedy: bool = False):
    """(params, batch, cache) -> (logits (B, V), cache), or with
    greedy=True (token ids (B,) int64, cache): the argmax lives in the step.
    batch carries the new token (B, 1) and cache_len, the position it
    takes; the cache is updated in place."""
    @torch.no_grad()
    def decode_step(params, batch, cache):
        logits, new_cache = zoo.forward(params, cfg, batch, mode="decode",
                                        cache=cache)
        logits = logits[:, -1]
        if not greedy:
            return logits, new_cache
        return torch.argmax(logits, dim=-1), new_cache
    return decode_step
