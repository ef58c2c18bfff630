"""Step functions: prefill and decode, the units the serving driver runs.

Reference: src/repro/launch/steps.py (`make_prefill_step`,
`make_decode_step`).  The reference jits them; the port runs the prefill
eagerly (it keeps the card busy: a graph would save nothing there) and
the decode step, on the card, as a CUDA graph (repro_torch/graphs.py)
captured once and replayed once per generated token, the counterpart of
the reference's one compile of the decode step (`trace_log`).  Both run
under `torch.no_grad`; the train steps come with the LLM training slice
(ROADMAP queue 1, item 6.6).
"""
from __future__ import annotations

import torch

from repro_torch import graphs, tree_leaves, tree_map
from repro_torch.models import zoo


def make_prefill_step(cfg):
    """(params, batch) -> (last_logits (B, V), cache)."""
    @torch.no_grad()
    def prefill_step(params, batch):
        logits, cache = zoo.forward(params, cfg, batch, mode="prefill",
                                    logits_positions="last")
        return logits[:, -1], cache
    return prefill_step


def make_decode_step(cfg, *, greedy: bool = False, trace_log: list = None):
    """(params, batch, cache) -> (logits (B, V), cache), or with
    greedy=True (token ids (B,) int64, cache): the argmax lives in the step.
    batch carries the new token, `tokens` (B, 1) or an audio model's
    `tokens_mc` (B, 1, K), and cache_len, the position it takes (an int,
    or a 0-dim int64 tensor on the device); the cache is updated in place.
    An audio model's logits are (B, K, V); greedy, it takes the argmax per
    codebook and keeps the first codebook's, as the reference does.

    On CPU tensors the step runs eagerly.  On the card the first call for
    a given (params, cache, batch shapes) runs eagerly on a side stream
    and is captured as a CUDA graph, which every later call replays after
    copying the batch into the graph's static buffers (the output is a
    copy of the graph's, so it outlives the next call).  `trace_log` — a
    list appended to once per capture (the batch's shapes), as the
    reference's is once per trace: a serving loop that never recaptures
    leaves one entry.  A capture or replay that fails raises."""
    @torch.no_grad()
    def eager(params, batch, cache):
        logits, new_cache = zoo.forward(params, cfg, batch, mode="decode",
                                        cache=cache)
        logits = logits[:, -1]
        if not greedy:
            return logits, new_cache
        tok = torch.argmax(logits, dim=-1)
        if tok.ndim > 1:                     # audio: (B, K) -> codebook 0
            tok = tok[:, 0]
        return tok, new_cache

    cache_of_graphs = graphs.GraphCache()
    statics = {}

    def decode_step(params, batch, cache):
        inputs = {k: v for k, v in batch.items() if k != "cache_len"}
        device = next(iter(inputs.values())).device
        if device.type != "cuda":
            return eager(params, batch, cache)
        batch = dict(inputs, cache_len=zoo.cache_len_tensor(batch, device))
        key = (graphs.signature(params), graphs.signature(cache),
               tuple((k, tuple(v.shape), v.dtype)
                     for k, v in sorted(batch.items())))
        graph = cache_of_graphs.get(key)
        if graph is None:
            out = graphs.warm_up(eager, params, batch, cache)
            static = tree_map(torch.clone, batch)

            def step():
                return eager(params, static, cache)[0]
            cache_of_graphs.capture(key, step, keep=(params, cache, static))
            statics[key] = static
            if trace_log is not None:
                trace_log.append({k: tuple(v.shape)
                                  for k, v in batch.items()})
            return out
        torch._foreach_copy_(tree_leaves(statics[key]), tree_leaves(batch))
        # a fresh tensor, as an eager call returns: the graph's own output
        # is overwritten by the next replay
        return graph.replay().clone(), cache

    decode_step.captures = cache_of_graphs.captures
    return decode_step
