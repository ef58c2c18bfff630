"""Model zoo: full-model init and forward for every LLM architecture.

Reference: src/repro/models/zoo.py (`init_params`, `param_count`,
`_embed_inputs`, `_project_out`, `forward`, `make_cache`, `pad_cache`).

    init_params(cfg, generator, device=None)      -> params tree
    forward(params, cfg, batch, mode, cache)      -> (logits, new_cache)
    make_cache(cfg, batch_size, max_len, device)  -> cache tree
    pad_cache(cache, extra)                       -> cache, k/v grown
    param_count(cfg, active_only=False)           -> analytic N

Batch dict keys (each optional but what the modality reads):
  tokens        (B, S) ids       text / code tokens; the VLM's text
  tokens_mc     (B, S, K) ids    audio: K parallel codebook streams
  input_embeds  (B, S, d)        audio: the stub EnCodec front end's frames
  patch_embeds  (B, P, d)        VLM: the stub vision encoder's patches,
                                 prepended to the text embeddings
  cache_len     () int64         decode: the count of valid cache entries
`cache_len` is a 0-dim int64 tensor on the device (a Python int is moved
there), as the reference's is a traced value, so one decode step serves
every position and a CUDA graph of it can be replayed with the position
in a static buffer.  An audio model's logits are (B, S, K, V), one row a
codebook.  Training (the loss and its chunked cross entropy) comes with
ROADMAP queue 1's item 6.6.
"""
from __future__ import annotations

import torch

from repro_torch import as_generator, resolve_device
from repro_torch.models import layers, moe, transformer

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def model_dtype(cfg) -> torch.dtype:
    return _DTYPES[cfg.dtype]


# ---------------------------------------------------------------------------
# Params
# ---------------------------------------------------------------------------

def init_params(cfg, generator, device=None):
    """Random weights from `generator` (a torch.Generator on `device`'s
    type, or an int seed), in cfg.dtype on `device` (None: cuda)."""
    device = resolve_device(device)
    gen = as_generator(generator, device)
    dtype = model_dtype(cfg)
    p = {"stack": transformer.stack_init(gen, cfg, dtype, device),
         "final_norm": layers.rmsnorm_init(cfg.d_model, dtype, device)}
    if cfg.modality == "audio_tokens":
        # K codebook embedding tables, stored as one (K Vpad, d) table,
        # and K output heads as one dense layer
        kv = cfg.num_codebooks * layers.pad_vocab(cfg.vocab_size)
        w = torch.randn((kv, cfg.d_model), generator=gen, device=device)
        p["embed"] = {"w": (w * 0.02).to(dtype)}
        p["heads"] = layers.dense_init(gen, cfg.d_model, kv, dtype=dtype,
                                       device=device)
        return p
    p["embed"] = layers.embed_init(gen, cfg.vocab_size, cfg.d_model, dtype,
                                   device)
    if not cfg.tie_embeddings:
        p["unembed"] = layers.dense_init(
            gen, cfg.d_model, layers.pad_vocab(cfg.vocab_size), dtype=dtype,
            device=device)
    return p


def param_count(cfg, active_only: bool = False) -> int:
    """Analytic parameter count (equal to init_params' leaves); with
    active_only, a MoE model counts the experts a token touches."""
    n = transformer.stack_param_count(cfg) + cfg.d_model
    if active_only and cfg.is_moe:
        pat = transformer.block_pattern(cfg)
        n_moe_layers = transformer.num_periods(cfg) * sum(
            1 for k in pat if k == "attn")
        n -= n_moe_layers * (moe.moe_param_count(cfg)
                             - moe.moe_active_param_count(cfg))
    vpad = layers.pad_vocab(cfg.vocab_size)
    if cfg.modality == "audio_tokens":
        return n + 2 * cfg.num_codebooks * vpad * cfg.d_model
    n += vpad * cfg.d_model
    if not cfg.tie_embeddings:
        n += vpad * cfg.d_model
    return n


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------

def _embed_inputs(p, cfg, batch):
    """Returns (h, positions): the text, audio or VLM inputs embedded, and
    positions 0..S-1 over the whole (prefix and text) sequence, or from
    cache_len on in decode."""
    dtype = model_dtype(cfg)
    if cfg.modality == "audio_tokens":
        if "input_embeds" in batch:           # the stub EnCodec front end
            h = batch["input_embeds"].to(dtype)
        else:
            toks = batch["tokens_mc"]         # (B, S, K)
            offs = torch.arange(cfg.num_codebooks, device=toks.device) \
                * layers.pad_vocab(cfg.vocab_size)
            h = layers.embed(p["embed"], toks + offs).sum(dim=2)
    elif cfg.modality == "vlm" and "patch_embeds" in batch:
        txt = layers.embed(p["embed"], batch["tokens"])
        h = torch.cat([batch["patch_embeds"].to(dtype), txt], dim=1)
    else:
        h = layers.embed(p["embed"], batch["tokens"])
    B, S = h.shape[0], h.shape[1]
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
    if cfg.modality == "audio_tokens":
        B, S = h.shape[0], h.shape[1]
        logits = layers.dense(p["heads"], h).reshape(
            B, S, cfg.num_codebooks, layers.pad_vocab(cfg.vocab_size))
        return logits[..., :cfg.vocab_size]
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


# MLA's compressed cache (c_kv, k_rope) grows too: without it a decode
# step would write at slot P of a cache of P slots
_CACHE_TIME_AXIS = {"k": -3, "v": -3, "c_kv": -2, "k_rope": -2}


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
