"""Block composition and the decoder stack.

Reference: src/repro/models/transformer.py (`block_pattern`, `num_periods`,
`_attn_block_init`, `_attn_block_apply`, `_shared_attn_init`,
`_zero_aux`, `block_init`, `block_apply`, `block_make_cache`,
`stack_init`, `stack_apply`, `stack_make_cache`, `stack_param_count`).

A model is a repeating `block_pattern` (a period) of typed blocks over
`num_layers // period` periods, plus optional pre-layers outside the
periods (DeepSeek-V2's dense layer 0) and Zamba2's parameter-SHARED
attention block.  Parameters are stacked per position in the period, with
a leading `nper` axis, as the reference stacks them for its `lax.scan`, so
converted weights copy over leaf for leaf; `stack_apply` loops over the
periods in Python, taking each period's parameters from one `unbind` of
each stacked leaf (so under autograd each leaf's gradient is stacked
once, not summed from a full-size gradient a period).  Caches stack their
per-period leaves the same way.  In train mode, with `cfg.remat` and
`cfg.scan_layers`, each period runs under `torch.utils.checkpoint` with
nothing saved inside it, the counterpart of the reference's
`jax.checkpoint(policy=nothing_saveable)` around its scanned period: the
backward recomputes the period's forward (one more `flash_attn_fwd` a
layer).  The pre-layers are not rematerialised, as in the reference.

Block kinds, every one of the reference's: "attn" (pre-norm attention,
GQA or MLA, then a dense MLP, or a MoE with Arctic's dense residual beside
it), "mamba" and "mamba+shared_attn" (Zamba2), "mlstm" and "slstm"
(xLSTM; each a pre-norm residual, x + block(norm(x))); and the port's
"hybrid", Zamba2-7B's published hybrid layer (`configs/zamba2_7b.py`):
the stack holds `cfg.num_mem_blocks` shared blocks ("mem_blocks": an
RMSNorm over [x, e], attention from 2 d_model to d_model at
`cfg.attn_scale`, an RMSNorm, the gated MLP), period p's hybrid runs
block p % num_mem_blocks with its own adapter on the MLP's gate/up
product and its own d x d "linear", whose output T enters the Mamba2
layer's input, x + Mamba2(norm(x + T)), and not the residual.  One
invocation of a shared block is the span "repro.shared_attn".  An unknown kind
raises ValueError, as in the reference.  Every block returns the MoE's
aux values (the load-balance and z losses, the expert load; zeros for a
block without a MoE), and `stack_apply` returns their sum over the
blocks, which the training loss reads.  Every kind trains: mamba2
through the SSD scan's autograd Function, mLSTM and sLSTM through their
chunk-checkpointed time scans, which nest inside the period's checkpoint
(each level recomputes once in the backward).

`mesh` (stack_apply, block_apply) is the mesh of torch.distributed ranks
that a MoE with `moe_impl="ep"` dispatches its experts over (`moe.
moe_apply_ep`); the reference reads the same from the ambient abstract
mesh (`launch/mesh.current_abstract_mesh`), which the port passes
explicitly.  None runs `moe_apply`, as the reference does with no mesh.
"""
from __future__ import annotations

import torch
import torch.utils.checkpoint

from repro_torch import tracing
from repro_torch import tree_leaves, tree_map, tree_stack, tree_unflatten
from repro_torch.models import attention, layers, moe, ssm


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


# ---------------------------------------------------------------------------
# The attention block
# ---------------------------------------------------------------------------

def _attn_block_init(generator, cfg, dtype, device=None, *, use_moe: bool):
    kw = dict(dtype=dtype, device=device)
    p = {"attn_norm": layers.rmsnorm_init(cfg.d_model, **kw),
         "attn": attention.attn_init(generator, cfg, dtype, device),
         "ffn_norm": layers.rmsnorm_init(cfg.d_model, **kw)}
    if use_moe:
        p["moe"] = moe.moe_init(generator, cfg, dtype, device)
        if cfg.moe.dense_residual:
            p["mlp"] = layers.mlp_init(generator, cfg.d_model, cfg.d_ff,
                                       act=cfg.act, **kw)
    else:
        p["mlp"] = layers.mlp_init(generator, cfg.d_model, cfg.d_ff,
                                   act=cfg.act, **kw)
    return p


def _attn_block_apply(p, cfg, x, positions, *, mode, cache, cache_len,
                      use_moe: bool, mesh=None):
    h, new_cache = attention.attn_apply(
        p["attn"], cfg, layers.rmsnorm(p["attn_norm"], x, cfg.norm_eps),
        positions, mode=mode, cache=cache, cache_len=cache_len)
    x = x + h
    hn = layers.rmsnorm(p["ffn_norm"], x, cfg.norm_eps)
    aux = _zero_aux(cfg, x.device)
    if use_moe:
        if mode == "decode":
            mo, aux = moe.moe_decode_apply(p["moe"], cfg, hn)
        elif cfg.moe_impl == "ep":
            mo, aux = moe.moe_apply_ep(p["moe"], cfg, hn, mesh=mesh)
        else:
            mo, aux = moe.moe_apply(p["moe"], cfg, hn)
        if cfg.moe.dense_residual:
            mo = mo + layers.mlp(p["mlp"], hn, act=cfg.act)
        x = x + mo
    else:
        x = x + layers.mlp(p["mlp"], hn, act=cfg.act)
    return x, new_cache, aux


def _zero_aux(cfg, device=None):
    z = dict(dtype=torch.float32, device=device)
    return {"lb_loss": torch.zeros((), **z), "z_loss": torch.zeros((), **z),
            "expert_load": torch.zeros((max(cfg.moe.num_experts, 1),), **z)}


def _add_aux(acc, aux):
    return {k: acc[k] + aux[k] for k in acc}


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


def _mem_block_init(generator, cfg, dtype, device=None):
    """One of Zamba2-7B's shared blocks: the norm of [x, e] (2 d_model),
    attention reading it, the MLP's norm and the gated MLP."""
    d, kw = cfg.d_model, dict(dtype=dtype, device=device)
    return {"norm": layers.rmsnorm_init(2 * d, **kw),
            "attn": attention.gqa_init(generator, cfg, dtype, device,
                                       d_in=2 * d),
            "ffn_norm": layers.rmsnorm_init(d, **kw),
            "mlp": layers.gated_mlp_init(generator, d, cfg.d_ff, **kw)}


def _mem_block_param_count(cfg) -> int:
    d = cfg.d_model
    return (2 * d + attention.gqa_param_count(cfg, d_in=2 * d) + d
            + 3 * d * cfg.d_ff)


def _hybrid_apply(p, cfg, x, positions, *, mode, cache, cache_len, shared,
                  emb0):
    """Zamba2-7B's hybrid layer: T = linear(shared block(x, e) with this
    invocation's adapter); x + Mamba2(norm(x + T))."""
    mcache = cache["mamba"] if cache is not None else None
    acache = cache["attn"] if cache is not None else None
    with tracing.span("shared_attn"):
        c = layers.rmsnorm(shared["norm"], torch.cat([x, emb0], dim=-1),
                           cfg.norm_eps)
        a, ast = attention.gqa_apply(shared["attn"], cfg, c, positions,
                                     mode=mode, cache=acache,
                                     cache_len=cache_len)
        t = layers.gated_mlp(
            shared["mlp"], layers.rmsnorm(shared["ffn_norm"], a,
                                          cfg.norm_eps),
            act=cfg.act, adapter=p["adapter"])
    T = layers.dense(p["linear"], t)
    h, mst = ssm.mamba2_apply(p["mamba"], cfg,
                              layers.rmsnorm(p["norm"], x + T, cfg.norm_eps),
                              mode=mode, state=mcache)
    return x + h, {"mamba": mst, "attn": ast}


# ---------------------------------------------------------------------------
# Blocks
# ---------------------------------------------------------------------------

def block_init(generator, cfg, kind: str, dtype, device=None, *,
               use_moe: bool = False):
    if kind == "attn":
        return _attn_block_init(generator, cfg, dtype, device,
                                use_moe=use_moe)
    if kind == "mamba":
        return {"norm": layers.rmsnorm_init(cfg.d_model, dtype, device),
                "mamba": ssm.mamba2_init(generator, cfg, dtype, device)}
    if kind == "mamba+shared_attn":
        return {"norm": layers.rmsnorm_init(cfg.d_model, dtype, device),
                "mamba": ssm.mamba2_init(generator, cfg, dtype, device),
                "adapter": layers.dense_init(generator, cfg.d_model,
                                             cfg.d_model, dtype=dtype,
                                             scale=1e-4, device=device)}
    if kind == "hybrid":
        d = cfg.d_model
        return {"norm": layers.rmsnorm_init(d, dtype, device),
                "mamba": ssm.mamba2_init(generator, cfg, dtype, device),
                "linear": layers.dense_init(generator, d, d, dtype=dtype,
                                            device=device),
                "adapter": layers.adapter_init(generator, d, cfg.adapter_rank,
                                               2 * cfg.d_ff, dtype=dtype,
                                               device=device)}
    if kind == "mlstm":
        return {"norm": layers.rmsnorm_init(cfg.d_model, dtype, device),
                "mlstm": ssm.mlstm_init(generator, cfg, dtype, device)}
    if kind == "slstm":
        return {"norm": layers.rmsnorm_init(cfg.d_model, dtype, device),
                "slstm": ssm.slstm_init(generator, cfg, dtype, device)}
    raise ValueError(kind)


def block_make_cache(cfg, kind: str, batch: int, max_len: int, dtype,
                     device=None):
    if kind == "attn":
        return attention.attn_make_cache(cfg, batch, max_len, dtype, device)
    if kind == "mamba":
        return ssm.mamba2_make_state(cfg, batch, dtype, device)
    if kind in ("mamba+shared_attn", "hybrid"):
        return {"mamba": ssm.mamba2_make_state(cfg, batch, dtype, device),
                "attn": attention.attn_make_cache(cfg, batch, max_len, dtype,
                                                  device)}
    if kind == "mlstm":
        return ssm.mlstm_make_state(cfg, batch, dtype, device)
    if kind == "slstm":
        return ssm.slstm_make_state(cfg, batch, dtype, device)
    raise ValueError(kind)


def block_apply(p, cfg, kind: str, x, positions, *, mode, cache=None,
                cache_len=None, shared=None, emb0=None, use_moe=False,
                mesh=None):
    """Returns (x, new_cache, aux)."""
    if kind == "attn":
        return _attn_block_apply(p, cfg, x, positions, mode=mode, cache=cache,
                                 cache_len=cache_len, use_moe=use_moe,
                                 mesh=mesh)
    aux = _zero_aux(cfg, x.device)
    if kind == "mamba":
        h, st = ssm.mamba2_apply(p["mamba"], cfg,
                                 layers.rmsnorm(p["norm"], x, cfg.norm_eps),
                                 mode=mode, state=cache)
        return x + h, st, aux
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
                           layers.rmsnorm(shared["ffn_norm"], g, cfg.norm_eps),
                           act=cfg.act)
        # per-invocation (unshared) output adapter
        x = x + layers.dense(p["adapter"], g)
        return x, {"mamba": mst, "attn": ast}, aux
    if kind == "hybrid":
        x, st = _hybrid_apply(p, cfg, x, positions, mode=mode, cache=cache,
                              cache_len=cache_len, shared=shared, emb0=emb0)
        return x, st, aux
    if kind in ("mlstm", "slstm"):
        apply = ssm.mlstm_apply if kind == "mlstm" else ssm.slstm_apply
        h, st = apply(p[kind], cfg,
                      layers.rmsnorm(p["norm"], x, cfg.norm_eps),
                      mode=mode, state=cache)
        return x + h, st, aux
    raise ValueError(kind)


# ---------------------------------------------------------------------------
# The stack
# ---------------------------------------------------------------------------

def _use_moe(cfg, kind: str) -> bool:
    return cfg.is_moe and kind == "attn"


def _stacked_blocks(make, nper: int):
    """One tree whose leaves stack `nper` calls of make() on a leading
    axis, holding no more than the stack and one block at a time: each
    block is copied in as it is made, and a single period's block is
    viewed, not copied (Arctic's one layer is 28 GB in bf16)."""
    block = make()
    if nper == 1:
        return tree_map(lambda t: t.unsqueeze(0), block)
    if tree_leaves(block)[0].device.type == "meta":   # shapes only
        return tree_map(lambda t: t.new_empty((nper,) + t.shape), block)
    out = tree_map(lambda t: t.new_empty((nper,) + t.shape), block)
    for per in range(nper):
        if per:
            del block
            block = make()
        for dst, src in zip(tree_leaves(out), tree_leaves(block)):
            dst[per].copy_(src)
    return out


def stack_init(generator, cfg, dtype, device=None):
    """{"pre": [DeepSeek-V2's dense pre-layers] (when it has any),
    "pattern": [one tree per period position, leaves (nper, ...)],
    "shared": the shared attention block (when the pattern uses it),
    "mem_blocks": [num_mem_blocks shared blocks] (when it has "hybrid")}."""
    pat = block_pattern(cfg)
    nper = num_periods(cfg)
    p = {}
    if cfg.moe.first_dense_layers:
        p["pre"] = [_attn_block_init(generator, cfg, dtype, device,
                                     use_moe=False)
                    for _ in range(cfg.moe.first_dense_layers)]
    p["pattern"] = [
        _stacked_blocks(lambda kind=kind: block_init(
            generator, cfg, kind, dtype, device,
            use_moe=_use_moe(cfg, kind)), nper) for kind in pat]
    if any("shared_attn" in k for k in pat):
        p["shared"] = _shared_attn_init(generator, cfg, dtype, device)
    if "hybrid" in pat:
        p["mem_blocks"] = [_mem_block_init(generator, cfg, dtype, device)
                           for _ in range(cfg.num_mem_blocks)]
    return p


def stack_param_count(cfg) -> int:
    pat = block_pattern(cfg)
    nper = num_periods(cfg)
    dense_mlp = layers.mlp_param_count(cfg.d_model, cfg.d_ff, cfg.act)
    ffn = dense_mlp
    if cfg.is_moe:
        ffn = moe.moe_param_count(cfg) + (
            dense_mlp if cfg.moe.dense_residual else 0)
    per_kind = {
        "attn": lambda: attention.attn_param_count(cfg) + 2 * cfg.d_model
        + ffn,
        "mamba": lambda: ssm.mamba2_param_count(cfg) + cfg.d_model,
        "mamba+shared_attn": lambda: (ssm.mamba2_param_count(cfg) + cfg.d_model
                                      + cfg.d_model * cfg.d_model),
        "hybrid": lambda: (ssm.mamba2_param_count(cfg) + cfg.d_model
                           + cfg.d_model * cfg.d_model + cfg.adapter_rank
                           * (cfg.d_model + 2 * cfg.d_ff)),
        "mlstm": lambda: ssm.mlstm_param_count(cfg) + cfg.d_model,
        "slstm": lambda: ssm.slstm_param_count(cfg) + cfg.d_model,
    }
    n = sum(nper * per_kind[kind]() for kind in pat)
    if cfg.moe.first_dense_layers:
        n += cfg.moe.first_dense_layers * (
            attention.attn_param_count(cfg) + 2 * cfg.d_model + dense_mlp)
    if any("shared_attn" in k for k in pat):
        n += (2 * cfg.d_model * cfg.d_model + 2 * cfg.d_model
              + attention.attn_param_count(cfg)
              + layers.mlp_param_count(cfg.d_model, cfg.d_ff, cfg.act))
    if "hybrid" in pat:
        n += cfg.num_mem_blocks * _mem_block_param_count(cfg)
    return n


def stack_make_cache(cfg, batch: int, max_len: int, dtype, device=None):
    nper = num_periods(cfg)
    cache = {}
    if cfg.moe.first_dense_layers:
        cache["pre"] = [block_make_cache(cfg, "attn", batch, max_len, dtype,
                                         device)
                        for _ in range(cfg.moe.first_dense_layers)]
    cache["pattern"] = [
        tree_map(lambda t: t.expand((nper,) + t.shape).clone(),
                 block_make_cache(cfg, kind, batch, max_len, dtype, device))
        for kind in block_pattern(cfg)]
    return cache


def _periods(tree, nper: int):
    """[tree of period i's views] for i < nper, from one `unbind(0)` of each
    stacked leaf (one backward node a leaf, not one full-size gradient a
    period)."""
    leaves = [t.unbind(0) for t in tree_leaves(tree)]
    return [tree_unflatten(tree, [u[i] for u in leaves]) for i in range(nper)]


def stack_apply(p, cfg, x, positions, *, mode, cache=None, cache_len=None,
                mesh=None):
    """x: (B, S, d) -> (x, new_cache, aux_sum).  'prefill' builds the
    cache, each leaf stacked over the periods; 'decode' updates `cache` in
    place and returns it; 'train' builds none (None) and, with cfg.remat
    and cfg.scan_layers, recomputes each period in the backward.  aux_sum
    is the blocks' aux values summed in the reference's order."""
    pat = block_pattern(cfg)
    nper = num_periods(cfg)
    shared, mem = p.get("shared"), p.get("mem_blocks")
    emb0 = x if shared is not None or mem is not None else None
    aux_sum = _zero_aux(cfg, x.device)
    new_cache = {}
    if "pre" in p:
        pre = []
        for i, bp in enumerate(p["pre"]):
            c = cache["pre"][i] if mode == "decode" else None
            x, nc, aux = block_apply(bp, cfg, "attn", x, positions, mode=mode,
                                     cache=c, cache_len=cache_len, mesh=mesh)
            aux_sum = _add_aux(aux_sum, aux)
            pre.append(nc)
        new_cache["pre"] = pre

    def period(x, aux_acc, params, caches, shared):
        ncs = []
        for i, kind in enumerate(pat):
            x, nc, aux = block_apply(
                params[i], cfg, kind, x, positions, mode=mode,
                cache=caches[i], cache_len=cache_len, shared=shared,
                emb0=emb0, use_moe=_use_moe(cfg, kind), mesh=mesh)
            aux_acc = _add_aux(aux_acc, aux)
            ncs.append(nc)
        return x, aux_acc, ncs

    remat = mode == "train" and cfg.remat and cfg.scan_layers
    params = list(zip(*[_periods(t, nper) for t in p["pattern"]]))
    outs = [[] for _ in pat]
    for per in range(nper):
        caches = ([tree_map(lambda t: t[per], c) for c in cache["pattern"]]
                  if mode == "decode" else [None] * len(pat))
        blk = shared if mem is None else mem[per % len(mem)]
        if remat:
            x, aux_sum, _ = torch.utils.checkpoint.checkpoint(
                period, x, aux_sum, params[per], caches, blk,
                use_reentrant=False)
        else:
            x, aux_sum, ncs = period(x, aux_sum, params[per], caches, blk)
            for i, nc in enumerate(ncs):
                outs[i].append(nc)
    if mode == "train":
        return x, None, aux_sum
    if mode == "decode":
        return x, cache, aux_sum
    new_cache["pattern"] = [tree_stack(o) for o in outs]
    return x, new_cache, aux_sum
