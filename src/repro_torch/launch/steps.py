"""Step functions: train, prefill and decode, the units the launcher and
the serving driver run.

Reference: src/repro/launch/steps.py (`grouped_batches`,
`stack_batches`, `make_train_step`, `make_prefill_step`,
`make_decode_step`, `make_inl_train_step`, `make_scan_train_step`,
`default_optimizer`).  The
reference jits them; the port runs the train step and the prefill
eagerly (they keep the card busy: a graph would save little there) and
the decode step, on the card, as a CUDA graph (repro_torch/graphs.py)
captured once and replayed once per generated token, the counterpart of
the reference's one compile of the decode step (`trace_log`).  Prefill
and decode run under `torch.no_grad`.  The train step takes gradients
with `torch.autograd.grad` over the parameter leaves of
`zoo.loss_and_metrics`; `make_scan_train_step` runs K of them in one
call, where the reference scans them.  INL over an LLM
(`make_inl_train_step`, scheme "inl") runs `core/inl_llm`'s step, which
draws its noise from a torch.Generator, one draw a step, or takes the
draws as data.
"""
from __future__ import annotations

from typing import Iterable, Iterator, List

import numpy as np
import torch

from repro_torch import graphs, optim, tree_leaves, tree_map
from repro_torch import tree_unflatten, value_and_grad
from repro_torch.core import inl_llm
from repro_torch.models import zoo


def grouped_batches(data: Iterable, k: int) -> Iterator[List]:
    """Chunk a batch stream into lists of k (a trailing partial group
    kept)."""
    group = []
    for batch in data:
        group.append(batch)
        if len(group) == k:
            yield group
            group = []
    if group:
        yield group


def stack_batches(group: List):
    """Stack a group of batches (dicts of numpy arrays, nested dicts
    allowed) into one of (K, ...) arrays on the host, the xs of
    `make_scan_train_step`."""
    first = group[0]
    if isinstance(first, dict):
        return {k: stack_batches([b[k] for b in group]) for k in first}
    return np.stack(group)


def make_train_step(cfg, optimizer, *, microbatches: int = 1,
                    unroll: bool = False):
    """(params, opt_state, batch) -> (params, opt_state, metrics), metrics
    detached tensors on the parameters' device with "grad_norm", the
    global norm of the gradients before clipping, added.  With
    inplace=True (keyword) the optimizer's `update_` updates the params
    and opt_state passed in, which come back, and gives the norm.

    microbatches > 1 splits the batch along axis 0 and accumulates the
    microbatches' gradients in fp32 buffers (never in a bf16 leaf's
    .grad, which would round every add), then divides by their count and
    averages their metrics.  `unroll` keeps the reference's signature:
    without a scan to unroll, the port's microbatch loop is always a
    Python loop."""
    del unroll

    def grads_of(params, batch):
        _, metrics, grads = value_and_grad(
            lambda p: zoo.loss_and_metrics(p, cfg, batch), params)
        return grads, {k: v.detach() for k, v in metrics.items()}

    def train_step(params, opt_state, batch, *, inplace: bool = False):
        if microbatches == 1:
            grads, metrics = grads_of(params, batch)
        else:
            B = tree_leaves(batch)[0].shape[0]
            if B % microbatches:
                raise ValueError(f"batch {B} does not split into "
                                 f"{microbatches} microbatches")
            n = B // microbatches
            gsum = [torch.zeros(t.shape, dtype=torch.float32,
                                device=t.device)
                    for t in tree_leaves(params)]
            ms = []
            for i in range(microbatches):
                one = tree_map(lambda x: x[i * n:(i + 1) * n], batch)
                grads, m = grads_of(params, one)
                for acc, g in zip(gsum, tree_leaves(grads)):
                    acc.add_(g)
                ms.append(m)
                del grads
            grads = tree_unflatten(params, [g / microbatches for g in gsum])
            metrics = {k: torch.stack([m[k] for m in ms]).mean(dim=0)
                       for k in ms[0]}
        if inplace:
            metrics["grad_norm"] = optimizer.update_(grads, opt_state, params)
            return params, opt_state, metrics
        new_params, new_opt = optimizer.update(grads, opt_state, params)
        metrics["grad_norm"] = optim.global_norm(grads)
        return new_params, new_opt, metrics
    return train_step


def make_prefill_step(cfg):
    """(params, batch) -> (last_logits (B, V), cache)."""
    @torch.no_grad()
    def prefill_step(params, batch):
        logits, cache, _ = zoo.forward(params, cfg, batch, mode="prefill",
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
        logits, new_cache, _ = zoo.forward(params, cfg, batch,
                                           mode="decode", cache=cache)
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


def make_inl_train_step(cfg, optimizer):
    """The paper's scheme on this architecture (core/inl_llm):
    (params, opt_state, batch, generator=None, *, noise=None, eps=None) ->
    (params, opt_state, metrics)."""
    return inl_llm.make_train_step(cfg, optimizer)


def _release(tree, keep) -> None:
    """Free the storage of `tree`'s leaves that no leaf of `keep` shares:
    the port's counterpart of donating a buffer (the caller's tensors are
    left empty)."""
    kept = {t.untyped_storage().data_ptr() for t in tree_leaves(keep)}
    for t in tree_leaves(tree):
        st = t.untyped_storage()
        if st.data_ptr() not in kept:
            st.resize_(0)


def make_scan_train_step(cfg, optimizer, *, scheme: str = "standard",
                         microbatches: int = 1, donate: bool = None):
    """K optimizer steps in one call: (params, opt_state, batches) ->
    (params, opt_state, metrics stacked over the K steps), `batches` the
    batch dict with a leading K axis (on the parameters' device).  The
    steps run back to back with no read on the host between them.  Where
    the optimizer updates in place (`update_`: AdamW), every step after
    the first updates the buffers the call made, and so does the first
    with donate (None: on a CUDA device, as the reference donates only on
    accelerators): the caller's params and opt_state are then updated in
    place, the counterpart of the reference's donated buffers, and the
    caller must not read them again.  Without donation the first step is
    the functional update, which leaves the caller's tensors as they
    were.  An optimizer without `update_` makes each step's params and
    state anew, the old dropped as the next are made (with donate, the
    caller's freed after the first step).

    scheme "inl" (INL over an LLM, `make_inl_train_step`): (params,
    opt_state, batches, generator=None, *, noise=None, eps=None), params
    an `inl_llm.INLLLMParams`; each step takes one draw, from `generator`
    (`inl_llm.draw_noise`), or step i takes noise[i] and eps[i] of the
    given (K, J, B, S, ...) stacks, where the reference takes one PRNG key
    a step."""
    if scheme == "inl":
        if microbatches != 1:
            raise ValueError("the inl scheme takes no microbatches")
        inl_step = make_inl_train_step(cfg, optimizer)

        def inner(params, opt_state, batch, i, generator, noise, eps, own):
            draws = {} if noise is None else {"noise": noise[i],
                                              "eps": eps[i]}
            return inl_step(params, opt_state, batch, generator, **draws,
                            inplace=own)
    elif scheme == "standard":
        train_step = make_train_step(cfg, optimizer,
                                     microbatches=microbatches)

        def inner(params, opt_state, batch, i, generator, noise, eps, own):
            return train_step(params, opt_state, batch, inplace=own)
    else:
        raise ValueError(f"scheme {scheme!r}: standard or inl")

    def epoch(params, opt_state, batches, generator=None, *, noise=None,
              eps=None):
        if scheme == "standard" and any(
                x is not None for x in (generator, noise, eps)):
            raise ValueError("the standard scheme draws nothing")
        if (noise is None) != (eps is None):
            raise ValueError("pass noise= and eps= together")
        K = tree_leaves(batches)[0].shape[0]
        give = donate if donate is not None \
            else tree_leaves(params)[0].device.type == "cuda"
        ms = []
        for i in range(K):
            batch = tree_map(lambda x: x[i], batches)
            # in place where the step owns the buffers: those it made, or
            # the caller's where they were given
            own = optimizer.update_ is not None and (i > 0 or give)
            new_params, new_opt, m = inner(params, opt_state, batch, i,
                                           generator, noise, eps, own)
            if i == 0 and give and not own:
                _release((params, opt_state), (new_params, new_opt))
            params, opt_state = new_params, new_opt
            del new_params, new_opt
            ms.append(m)
        return params, opt_state, {k: torch.stack([m[k] for m in ms])
                                   for k in ms[0]}
    return epoch


def default_optimizer(cfg, total_steps: int = 10_000):
    """AdamW at 3e-4 with warmup and cosine decay, weight decay 0.1,
    clipped at a global norm of 1: the reference's LLM optimizer."""
    sched = optim.warmup_cosine_schedule(
        3e-4, min(200, total_steps // 10 + 1), total_steps)
    return optim.adamw(sched, weight_decay=0.1, clip_norm=1.0)
