"""Attention: GQA/MQA/MHA with RoPE, sliding windows and KV caches.

Reference: src/repro/models/attention.py (`gqa_init`, `gqa_param_count`,
`gqa_make_cache`, `gqa_apply`, `decode_attention` and the `attn_*`
fronts).  Prefill goes through `kernels/ops.attention`: the flash kernel
on the card, its plain version on the CPU (the reference's model runs the
same contract as a jnp blockwise scan).  Decode is one token against the
cache in plain torch, softmax in fp32, with the reference's bf16
roundings of the scaled query and the softmax weights.  DeepSeek-V2's
MLA comes with a later slice of the LLM stack and raises here.

The decode step writes the new token's k/v into the cache in place (the
reference donates the cache buffers to the same effect) and returns the
same cache.
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels import ops
from repro_torch.models import layers

NEG_INF = -1e30
_MLA = ("MLA (DeepSeek-V2 multi-head latent attention) is not ported yet; "
        "it comes with the LLM stack's MLA slice (ROADMAP queue 1, item 6)")


def decode_attention(q, k_cache, v_cache, cache_len, k_new, v_new, *,
                     exclude_slot=None):
    """Single-token attention against a cache.

    q: (B, 1, H, Dh); caches: (B, W, KV, Dh); cache_len: the count of valid
    entries (for a ring buffer, W once wrapped), an int or a 0-dim integer
    tensor on q's device; entries >= cache_len are masked, and
    `exclude_slot` (likewise) too.  k_new/v_new (B, 1, KV, Dh): the
    current token's kv, attended explicitly so the cache is read before it
    is written.

    As in the reference, q * scale is rounded to the cache's dtype before
    both score products and the softmax weights to v's before the PV
    product; scores and the output accumulate in fp32 (the reference's
    preferred_element_type).  On the card a low-precision cache enters
    its products as it is (`torch.bmm(..., out_dtype=torch.float32)` on
    strided views), so no fp32 copy of a cache is made; the CPU has no
    such product and upcasts, which is exact."""
    B, _, H, Dh = q.shape
    _, W, KV, _ = k_cache.shape
    g = H // KV
    qc = (q.float() * (1.0 / math.sqrt(Dh))).to(k_cache.dtype) \
        .reshape(B, KV, g, Dh)
    # (B, KV, g, Dh) x (B, W, KV, Dh) -> (B, KV, g, W)
    s = _cache_product(qc, k_cache.permute(0, 2, 3, 1))
    valid = torch.arange(W, device=q.device) < cache_len
    if exclude_slot is not None:
        # ring buffer wrapped: the stale entry that the current token is
        # about to overwrite must not be attended
        valid = valid & (torch.arange(W, device=q.device) != exclude_slot)
    s = torch.where(valid, s, torch.full_like(s, NEG_INF))
    s_new = torch.einsum("bkgd,bkd->bkg", qc.float(), k_new[:, 0].float())
    m = torch.maximum(s.amax(dim=-1), s_new)
    p = torch.exp(s - m[..., None])
    p_new = torch.exp(s_new - m)
    denom = p.sum(dim=-1) + p_new
    # (B, KV, g, W) x (B, W, KV, Dh) -> (B, KV, g, Dh)
    out = (_cache_product(p.to(v_cache.dtype), v_cache.permute(0, 2, 1, 3))
           + p_new[..., None] * v_new[:, 0, :, None, :].float()
           ) / denom[..., None]
    return out.reshape(B, 1, H, Dh).to(q.dtype)


def _cache_product(a, cache_view):
    """a (B, KV, m, k) @ cache_view (B, KV, k, n), a cache's strided view,
    as an fp32 result.  On the card a low-precision cache takes one
    product with an fp32 output per batch row (each row's (KV, k, n) view
    has a single batch stride, so cuBLAS reads the cache in place) and an
    fp32 cache one fp32 matmul.  On the CPU the operands are upcast (exact
    for bf16) and summed over k one term after another, the order of
    XLA's CPU dot for one query per kv head, so that there the products
    equal the reference's bit for bit."""
    if cache_view.device.type == "cuda":
        if cache_view.dtype == torch.float32:
            return torch.matmul(a, cache_view)
        return torch.stack([torch.bmm(a[b], cache_view[b],
                                      out_dtype=torch.float32)
                            for b in range(a.shape[0])])
    a, cache_view = a.float(), cache_view.float()
    out = a[..., 0, None] * cache_view[..., 0, None, :]
    for i in range(1, a.shape[-1]):
        out = out + a[..., i, None] * cache_view[..., i, None, :]
    return out


# ---------------------------------------------------------------------------
# GQA module
# ---------------------------------------------------------------------------

def gqa_init(generator, cfg, dtype, device=None):
    d, H, KV, Dh = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    kw = dict(bias=cfg.qkv_bias, dtype=dtype, device=device)
    return {
        "wq": layers.dense_init(generator, d, H * Dh, **kw),
        "wk": layers.dense_init(generator, d, KV * Dh, **kw),
        "wv": layers.dense_init(generator, d, KV * Dh, **kw),
        "wo": layers.dense_init(generator, H * Dh, d, dtype=dtype,
                                device=device),
    }


def gqa_param_count(cfg) -> int:
    d, H, KV, Dh = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    n = d * H * Dh * 2 + d * KV * Dh * 2
    if cfg.qkv_bias:
        n += H * Dh + 2 * KV * Dh
    return n


def gqa_make_cache(cfg, batch: int, max_len: int, dtype, device=None):
    W = min(max_len, cfg.sliding_window) if cfg.sliding_window else max_len
    shape = (batch, W, cfg.num_kv_heads, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def gqa_apply(p, cfg, x, positions, *, mode: str, cache=None,
              cache_len=None):
    """x: (B, S, d).  mode 'prefill' -> full-sequence causal attention
    (`ops.attention`) and a filled cache; mode 'decode' -> S == 1 against
    the cache, which is updated in place.  Returns (y, new_cache)."""
    B, S, d = x.shape
    H, KV, Dh = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    q = layers.dense(p["wq"], x).reshape(B, S, H, Dh)
    k = layers.dense(p["wk"], x).reshape(B, S, KV, Dh)
    v = layers.dense(p["wv"], x).reshape(B, S, KV, Dh)
    q = layers.apply_rope(q, positions, cfg.rope_theta)
    k = layers.apply_rope(k, positions, cfg.rope_theta)

    if mode == "decode":
        if cache is None or S != 1:
            raise ValueError("decode takes one token and a cache")
        # cache_len is a 0-dim int64 tensor on the device (models/zoo):
        # the slot and the valid count are device values too, and the
        # cache writes index with a 1-element tensor, never through the
        # host
        if not isinstance(cache_len, torch.Tensor):
            cache_len = torch.full((), int(cache_len), dtype=torch.int64,
                                   device=x.device)
        W = cache["k"].shape[1]
        slot = torch.remainder(cache_len, W) if cfg.sliding_window \
            else cache_len
        # attend over the old cache + the new token explicitly, then write
        n_valid = torch.clamp(cache_len, max=W)
        excl = slot if cfg.sliding_window else None
        out = decode_attention(q, cache["k"], cache["v"], n_valid, k, v,
                               exclude_slot=excl)
        at = slot.reshape(1)
        cache["k"].index_copy_(1, at, k.to(cache["k"].dtype))
        cache["v"].index_copy_(1, at, v.to(cache["v"].dtype))
        new_cache = cache
    elif mode == "prefill":
        out = ops.attention(q, k, v, causal=True, window=cfg.sliding_window)
        W = min(S, cfg.sliding_window) if cfg.sliding_window else S
        kc, vc = k[:, S - W:], v[:, S - W:]
        if cfg.sliding_window and S > W:
            # ring alignment: slot j must hold the token with pos % W == j
            shift = (S - W) % W
            kc = torch.roll(kc, shift, dims=1)
            vc = torch.roll(vc, shift, dims=1)
        new_cache = {"k": kc.contiguous(), "v": vc.contiguous()}
    else:
        raise NotImplementedError(
            f"attention mode {mode!r}: the port serves (prefill, decode); "
            "training comes with the LLM training slice (ROADMAP queue 1, "
            "item 6)")
    y = layers.dense(p["wo"], out.reshape(B, S, H * Dh))
    return y, new_cache


# ---------------------------------------------------------------------------
# Unified front (MLA raises)
# ---------------------------------------------------------------------------

def attn_init(generator, cfg, dtype, device=None):
    if cfg.use_mla:
        raise NotImplementedError(_MLA)
    return gqa_init(generator, cfg, dtype, device)


def attn_param_count(cfg) -> int:
    if cfg.use_mla:
        raise NotImplementedError(_MLA)
    return gqa_param_count(cfg)


def attn_make_cache(cfg, batch: int, max_len: int, dtype, device=None):
    if cfg.use_mla:
        raise NotImplementedError(_MLA)
    return gqa_make_cache(cfg, batch, max_len, dtype, device)


def attn_apply(p, cfg, x, positions, *, mode: str, cache=None,
               cache_len=None):
    if cfg.use_mla:
        raise NotImplementedError(_MLA)
    return gqa_apply(p, cfg, x, positions, mode=mode, cache=cache,
                     cache_len=cache_len)
