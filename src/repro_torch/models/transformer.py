"""Block composition and the decoder stack.

Reference: src/repro/models/transformer.py (`block_pattern`, `num_periods`,
`_shared_attn_init`, `block_init`, `block_apply`, `block_make_cache`,
`stack_init`, `stack_apply`, `stack_make_cache`, `stack_param_count`).

A model is a repeating `block_pattern` (a period) of typed blocks over
`num_layers // period` periods, plus Zamba2's parameter-SHARED attention
block.  Parameters are stacked per position in the period, with a leading
`nper` axis, as the reference stacks them for its `lax.scan`, so converted
weights copy over leaf for leaf; `stack_apply` loops over the periods in
Python.  Caches stack their per-period leaves the same way.

Block kinds ported: "mamba" and "mamba+shared_attn" (Zamba2).  The "attn"
block (dense and MoE transformers), DeepSeek-V2's dense pre-layers and the
xLSTM blocks come with later slices of the LLM stack and raise.
"""
from __future__ import annotations

import torch

from repro_torch import tree_map, tree_stack
from repro_torch.models import attention, layers, ssm

PORTED_KINDS = ("mamba", "mamba+shared_attn")


def _not_ported(what: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported yet; it comes with a later slice of the LLM "
        "stack (ROADMAP queue 1, item 6)")


def block_pattern(cfg):
    if cfg.block_pattern:
        return tuple(cfg.block_pattern)
    return ("attn",)


def num_periods(cfg):
    pat = block_pattern(cfg)
    n_scanned = cfg.num_layers - cfg.moe.first_dense_layers
    if n_scanned % len(pat):
        raise ValueError(f"{cfg.name}: {n_scanned} layers not divisible by "
                         f"period {len(pat)}")
    return n_scanned // len(pat)


def _check_ported(cfg) -> None:
    for kind in block_pattern(cfg):
        if kind not in PORTED_KINDS:
            raise _not_ported(f"the {kind!r} block kind")
    if cfg.is_moe or cfg.moe.first_dense_layers:
        raise _not_ported("MoE")
    if cfg.use_mla:
        raise _not_ported("MLA")


# ---------------------------------------------------------------------------
# Shared global attention (Zamba2)
# ---------------------------------------------------------------------------

def _shared_attn_init(generator, cfg, dtype, device=None):
    kw = dict(dtype=dtype, device=device)
    return {
        "in_proj": layers.dense_init(generator, 2 * cfg.d_model, cfg.d_model,
                                     **kw),
        "norm": layers.rmsnorm_init(cfg.d_model, **kw),
        "attn": attention.attn_init(generator, cfg, dtype, device),
        "ffn_norm": layers.rmsnorm_init(cfg.d_model, **kw),
        "ffn": layers.mlp_init(generator, cfg.d_model, cfg.d_ff, act=cfg.act,
                               **kw),
    }


# ---------------------------------------------------------------------------
# Blocks
# ---------------------------------------------------------------------------

def block_init(generator, cfg, kind: str, dtype, device=None):
    if kind == "mamba":
        return {"norm": layers.rmsnorm_init(cfg.d_model, dtype, device),
                "mamba": ssm.mamba2_init(generator, cfg, dtype, device)}
    if kind == "mamba+shared_attn":
        return {"norm": layers.rmsnorm_init(cfg.d_model, dtype, device),
                "mamba": ssm.mamba2_init(generator, cfg, dtype, device),
                "adapter": layers.dense_init(generator, cfg.d_model,
                                             cfg.d_model, dtype=dtype,
                                             scale=1e-4, device=device)}
    raise _not_ported(f"the {kind!r} block kind")


def block_make_cache(cfg, kind: str, batch: int, max_len: int, dtype,
                     device=None):
    if kind == "mamba":
        return ssm.mamba2_make_state(cfg, batch, dtype, device)
    if kind == "mamba+shared_attn":
        return {"mamba": ssm.mamba2_make_state(cfg, batch, dtype, device),
                "attn": attention.attn_make_cache(cfg, batch, max_len, dtype,
                                                  device)}
    raise _not_ported(f"the {kind!r} block kind")


def block_apply(p, cfg, kind: str, x, positions, *, mode, cache=None,
                cache_len=None, shared=None, emb0=None):
    """Returns (x, new_cache)."""
    if kind == "mamba":
        h, st = ssm.mamba2_apply(p["mamba"], cfg,
                                 layers.rmsnorm(p["norm"], x, cfg.norm_eps),
                                 mode=mode, state=cache)
        return x + h, st
    if kind == "mamba+shared_attn":
        mcache = cache["mamba"] if cache is not None else None
        acache = cache["attn"] if cache is not None else None
        h, mst = ssm.mamba2_apply(p["mamba"], cfg,
                                  layers.rmsnorm(p["norm"], x, cfg.norm_eps),
                                  mode=mode, state=mcache)
        x = x + h
        # the shared block reads [x, the stack's input embeddings]
        g = layers.dense(shared["in_proj"], torch.cat([x, emb0], dim=-1))
        hh, ast = attention.attn_apply(
            shared["attn"], cfg,
            layers.rmsnorm(shared["norm"], g, cfg.norm_eps),
            positions, mode=mode, cache=acache, cache_len=cache_len)
        g = g + hh
        g = g + layers.mlp(shared["ffn"],
                           layers.rmsnorm(shared["ffn_norm"], g, cfg.norm_eps))
        # per-invocation (unshared) output adapter
        x = x + layers.dense(p["adapter"], g)
        return x, {"mamba": mst, "attn": ast}
    raise _not_ported(f"the {kind!r} block kind")


# ---------------------------------------------------------------------------
# The stack
# ---------------------------------------------------------------------------

def stack_init(generator, cfg, dtype, device=None):
    """{"pattern": [one tree per period position, leaves (nper, ...)],
    "shared": the shared attention block (when the pattern uses it)}."""
    _check_ported(cfg)
    pat = block_pattern(cfg)
    nper = num_periods(cfg)
    p = {"pattern": [
        tree_stack([block_init(generator, cfg, kind, dtype, device)
                    for _ in range(nper)]) for kind in pat]}
    if any("shared_attn" in k for k in pat):
        p["shared"] = _shared_attn_init(generator, cfg, dtype, device)
    return p


def stack_param_count(cfg) -> int:
    _check_ported(cfg)
    pat = block_pattern(cfg)
    nper = num_periods(cfg)
    per_kind = {
        "mamba": lambda: ssm.mamba2_param_count(cfg) + cfg.d_model,
        "mamba+shared_attn": lambda: (ssm.mamba2_param_count(cfg) + cfg.d_model
                                      + cfg.d_model * cfg.d_model),
    }
    n = sum(nper * per_kind[kind]() for kind in pat)
    if any("shared_attn" in k for k in pat):
        n += (2 * cfg.d_model * cfg.d_model + 2 * cfg.d_model
              + attention.attn_param_count(cfg)
              + layers.mlp_param_count(cfg.d_model, cfg.d_ff, cfg.act))
    return n


def stack_make_cache(cfg, batch: int, max_len: int, dtype, device=None):
    _check_ported(cfg)
    nper = num_periods(cfg)
    return {"pattern": [
        tree_map(lambda t: t.expand((nper,) + t.shape).clone(),
                 block_make_cache(cfg, kind, batch, max_len, dtype, device))
        for kind in block_pattern(cfg)]}


def stack_apply(p, cfg, x, positions, *, mode, cache=None, cache_len=None):
    """x: (B, S, d) -> (x, new_cache).  'prefill' builds the cache, each
    leaf stacked over the periods; 'decode' updates `cache` in place and
    returns it."""
    _check_ported(cfg)
    pat = block_pattern(cfg)
    nper = num_periods(cfg)
    shared = p.get("shared")
    emb0 = x if shared is not None else None
    outs = [[] for _ in pat]
    for per in range(nper):
        for i, kind in enumerate(pat):
            bp = tree_map(lambda t: t[per], p["pattern"][i])
            c = (tree_map(lambda t: t[per], cache["pattern"][i])
                 if mode == "decode" else None)
            x, nc = block_apply(bp, cfg, kind, x, positions, mode=mode,
                                cache=c, cache_len=cache_len, shared=shared,
                                emb0=emb0)
            if mode != "decode":
                outs[i].append(nc)
    if mode == "decode":
        return x, cache
    return x, {"pattern": [tree_stack(o) for o in outs]}
