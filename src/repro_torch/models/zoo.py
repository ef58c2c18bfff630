"""Model zoo: full-model init and forward for the ported architectures.

Reference: src/repro/models/zoo.py (`init_params`, `param_count`,
`_embed_inputs`, `_project_out`, `forward`, `make_cache`, `pad_cache`).

    init_params(cfg, generator, device=None)      -> params tree
    forward(params, cfg, batch, mode, cache)      -> (logits, new_cache)
    make_cache(cfg, batch_size, max_len, device)  -> cache tree
    pad_cache(cache, extra)                       -> cache, k/v grown
    param_count(cfg)                              -> analytic N

Batch dict keys: `tokens` (B, S) integer ids; `cache_len` (decode) the
count of valid cache entries: a 0-dim int64 tensor on the device (a
Python int is moved there), as the reference's is a traced value, so one
decode step serves every position and a CUDA graph of it can be replayed
with the position in a static buffer.  Text models only: the audio
and VLM front ends come with a later slice of the LLM stack, as does
training (the loss and its chunked cross entropy).
"""
from __future__ import annotations

import torch

from repro_torch import as_generator, resolve_device
from repro_torch.models import layers, transformer

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def model_dtype(cfg) -> torch.dtype:
    return _DTYPES[cfg.dtype]


def _check_text(cfg) -> None:
    if cfg.modality != "text":
        raise NotImplementedError(
            f"modality {cfg.modality!r} is not ported yet; the audio and VLM "
            "front ends come with a later slice of the LLM stack (ROADMAP "
            "queue 1, item 6)")


# ---------------------------------------------------------------------------
# Params
# ---------------------------------------------------------------------------

def init_params(cfg, generator, device=None):
    """Random weights from `generator` (a torch.Generator on `device`'s
    type, or an int seed), in cfg.dtype on `device` (None: cuda)."""
    _check_text(cfg)
    device = resolve_device(device)
    gen = as_generator(generator, device)
    dtype = model_dtype(cfg)
    p = {"stack": transformer.stack_init(gen, cfg, dtype, device),
         "final_norm": layers.rmsnorm_init(cfg.d_model, dtype, device),
         "embed": layers.embed_init(gen, cfg.vocab_size, cfg.d_model, dtype,
                                    device)}
    if not cfg.tie_embeddings:
        p["unembed"] = layers.dense_init(
            gen, cfg.d_model, layers.pad_vocab(cfg.vocab_size), dtype=dtype,
            device=device)
    return p


def param_count(cfg) -> int:
    """Analytic parameter count (equal to init_params' leaves)."""
    _check_text(cfg)
    n = transformer.stack_param_count(cfg) + cfg.d_model
    vpad = layers.pad_vocab(cfg.vocab_size)
    n += vpad * cfg.d_model
    if not cfg.tie_embeddings:
        n += vpad * cfg.d_model
    return n


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------

def _embed_inputs(p, cfg, batch):
    """Returns (h, positions) for text tokens; decode positions start at
    cache_len."""
    _check_text(cfg)
    tokens = batch["tokens"]
    h = layers.embed(p["embed"], tokens)
    B, S = tokens.shape
    positions = torch.arange(S, device=h.device)
    start = cache_len_tensor(batch, h.device)
    if start is not None:
        positions = start + positions
    return h, positions.expand(B, S)


def cache_len_tensor(batch, device):
    """The batch's `cache_len` as a 0-dim int64 tensor on `device` (None
    when the batch has none)."""
    start = batch.get("cache_len")
    if start is None:
        return None
    if isinstance(start, torch.Tensor):
        return start.to(device=device, dtype=torch.int64)
    # a fill on the device, not a copy from the host (which would wait)
    return torch.full((), int(start), dtype=torch.int64, device=device)


def _project_out(p, cfg, h):
    if cfg.tie_embeddings:
        return layers.unembed(p["embed"], h, cfg.vocab_size)
    return layers.dense(p["unembed"], h)[..., :cfg.vocab_size]


def forward(params, cfg, batch, *, mode: str, cache=None,
            logits_positions: str = "all"):
    """Returns (logits, new_cache).  mode 'prefill' fills a cache for the
    prompt; 'decode' runs one token per sequence against `cache` (updated
    in place).  logits_positions='last' projects only the final position."""
    h, positions = _embed_inputs(params, cfg, batch)
    h, new_cache = transformer.stack_apply(
        params["stack"], cfg, h, positions, mode=mode, cache=cache,
        cache_len=cache_len_tensor(batch, h.device))
    h = layers.rmsnorm(params["final_norm"], h, cfg.norm_eps)
    if logits_positions == "last":
        h = h[:, -1:]
    return _project_out(params, cfg, h), new_cache


def make_cache(cfg, batch_size: int, max_len: int, device=None):
    return transformer.stack_make_cache(cfg, batch_size, max_len,
                                        model_dtype(cfg),
                                        resolve_device(device))


_CACHE_TIME_AXIS = {"k": -3, "v": -3}


def pad_cache(cache, extra: int):
    """Grow every attention cache's time axis by `extra` zero slots (after
    prefill, to make room for generated tokens).  SSM states are untouched:
    the new cache holds the same tensors, which decode then updates in
    place."""
    def walk(tree, name=None):
        if isinstance(tree, dict):
            return {k: walk(v, k) for k, v in tree.items()}
        if isinstance(tree, list):
            return [walk(v, name) for v in tree]
        ax = _CACHE_TIME_AXIS.get(name)
        if ax is None:
            return tree
        shape = list(tree.shape)
        shape[ax] = extra
        return torch.cat([tree, tree.new_zeros(shape)], dim=ax)
    return walk(cache)
