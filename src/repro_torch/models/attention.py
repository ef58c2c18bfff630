"""Attention: GQA/MQA/MHA with RoPE, sliding windows and KV caches, and
DeepSeek-V2's MLA (multi-head latent attention) with compressed-cache
decode.

Reference: src/repro/models/attention.py (`blockwise_attention` with its
custom VJP `_flash_fwd` / `_flash_bwd`, `gqa_init`, `gqa_param_count`,
`gqa_make_cache`, `gqa_apply`, `decode_attention`, `mla_init`,
`mla_param_count`, `mla_make_cache`, `_mla_q`, `mla_apply` and the
`attn_*` fronts).  Prefill goes through `kernels/ops.attention`: the flash
kernel on the card, its plain version on the CPU (the reference's model
runs the same contract as a jnp blockwise scan); MLA's prefill pads v up
to the qk head dim (192 at DeepSeek-V2's widths) to make one call.
Train mode runs the same projections and `blockwise_attention`, an
autograd Function whose forward is that call with the logsumexp asked
for (`ops.attention(..., return_lse=True)`) and whose backward is one
`ops.attention_bwd` call from the saved (q, k, v, out, lse): the
flash_attn_bwd kernel on the card, on the CPU its plain version
`ref.flash_bwd_ref`, the reference's `_flash_bwd` line for line in fp32
torch (the reference computes it in jnp outside any Pallas kernel).
Decode is one token against the cache in plain torch, softmax in fp32,
with the reference's bf16 roundings: GQA's of the scaled query and the
softmax weights, MLA's of the absorbed query and the weights in the
compressed space.

The decode step writes the new token's cache entries in place (the
reference donates the cache buffers to the same effect) and returns the
same cache.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops
from repro_torch.models import layers

NEG_INF = -1e30


# ---------------------------------------------------------------------------
# Blockwise attention for training: the flash forward, a hand-written VJP
# ---------------------------------------------------------------------------

class _BlockwiseAttention(torch.autograd.Function):
    """The reference's `_blockwise_attention_vjp`: the forward is one
    `ops.attention` call that also returns the logsumexp (flash_attn_fwd
    on the card, `ref.attention_ref` on the CPU), the backward one
    `ops.attention_bwd` call from the saved (q, k, v, out, lse)
    (flash_attn_bwd on the card, `ref.flash_bwd_ref` on the CPU, which
    alone reads block_q and block_k)."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, q_offset, block_q, block_k,
                scale):
        q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
        out, lse = ops.attention(q, k, v, causal=causal, window=window,
                                 q_offset=q_offset, return_lse=True,
                                 scale=scale)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.opts = dict(causal=causal, window=window, q_offset=q_offset,
                        block_q=block_q, block_k=block_k, scale=scale)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = ops.attention_bwd(q, k, v, out, lse, dout.contiguous(),
                                       **ctx.opts)
        return dq, dk, dv, None, None, None, None, None, None


def blockwise_attention(q, k, v, *, causal: bool = True, window: int = 0,
                        q_offset: int = 0, block_q: int = 512,
                        block_k: int = 512, scale=None):
    """Attention with the reference's flash-style VJP.  q: (B, Sq, H, Dh);
    k, v: (B, Sk, KV, Dh), H % KV == 0.  The scores are scale q.k, scale
    None meaning 1/sqrt(Dh) (Zamba2-7B's shared attention runs at
    (Dh / 2)^-1/2); the forward and backward kernels take it as an
    argument; it must be a positive finite number.  Returns (B, Sq, H,
    Dh) in q's dtype."""
    if scale is not None and not (math.isfinite(scale) and scale > 0):
        raise ValueError(f"blockwise_attention takes a positive finite "
                         f"scale; got {scale}")
    return _BlockwiseAttention.apply(q, k, v, causal, int(window),
                                     int(q_offset), block_q, block_k,
                                     None if scale is None else float(scale))


def decode_attention(q, k_cache, v_cache, cache_len, k_new, v_new, *,
                     exclude_slot=None, scale=None):
    """Single-token attention against a cache.

    q: (B, 1, H, Dh); caches: (B, W, KV, Dh); cache_len: the count of valid
    entries (for a ring buffer, W once wrapped), an int or a 0-dim integer
    tensor on q's device; entries >= cache_len are masked, and
    `exclude_slot` (likewise) too.  k_new/v_new (B, 1, KV, Dh): the
    current token's kv, attended explicitly so the cache is read before it
    is written.  scale: the scores' (None: 1/sqrt(Dh)).

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
    scale = 1.0 / math.sqrt(Dh) if scale is None else scale
    qc = (q.float() * scale).to(k_cache.dtype) \
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
    equal the reference's bit for bit.  On `meta` tensors (the dry-run)
    it is one product, as on the card."""
    if cache_view.device.type == "meta":
        return torch.matmul(a, cache_view).float()
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

def gqa_init(generator, cfg, dtype, device=None, *, d_in: int = 0):
    """q, k, v read an input of width d_in (0: d_model; Zamba2-7B's shared
    attention reads [h, e], 2 d_model), o writes d_model."""
    d, H, KV, Dh = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    d_in = d_in or d
    kw = dict(bias=cfg.qkv_bias, dtype=dtype, device=device)
    return {
        "wq": layers.dense_init(generator, d_in, H * Dh, **kw),
        "wk": layers.dense_init(generator, d_in, KV * Dh, **kw),
        "wv": layers.dense_init(generator, d_in, KV * Dh, **kw),
        "wo": layers.dense_init(generator, H * Dh, d, dtype=dtype,
                                device=device),
    }


def gqa_param_count(cfg, *, d_in: int = 0) -> int:
    d, H, KV, Dh = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    d_in = d_in or d
    n = d_in * (H + 2 * KV) * Dh + H * Dh * d
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
    """x: (B, S, d).  mode 'train' -> full-sequence causal attention
    through `blockwise_attention` and no cache; 'prefill' -> the same
    attention forward (`ops.attention`) and a filled cache; 'decode' ->
    S == 1 against the cache, which is updated in place.  Returns (y,
    new_cache)."""
    B, S, _ = x.shape
    H, KV, Dh = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    scale = cfg.attn_scale or None
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
                               exclude_slot=excl, scale=scale)
        at = slot.reshape(1)
        cache["k"].index_copy_(1, at, k.to(cache["k"].dtype))
        cache["v"].index_copy_(1, at, v.to(cache["v"].dtype))
        new_cache = cache
    elif mode == "prefill":
        out = ops.attention(q, k, v, causal=True, window=cfg.sliding_window,
                            scale=scale)
        W = min(S, cfg.sliding_window) if cfg.sliding_window else S
        kc, vc = k[:, S - W:], v[:, S - W:]
        if cfg.sliding_window and S > W:
            # ring alignment: slot j must hold the token with pos % W == j
            shift = (S - W) % W
            kc = torch.roll(kc, shift, dims=1)
            vc = torch.roll(vc, shift, dims=1)
        new_cache = {"k": kc.contiguous(), "v": vc.contiguous()}
    elif mode == "train":
        out = blockwise_attention(q, k, v, causal=True,
                                  window=cfg.sliding_window,
                                  block_q=cfg.attn_block_q or 512,
                                  block_k=cfg.attn_block_k or 512,
                                  scale=scale)
        new_cache = None
    else:
        raise ValueError(f"attention mode {mode!r}: one of train, prefill, "
                         f"decode")
    y = layers.dense(p["wo"], out.reshape(B, S, H * Dh))
    return y, new_cache


# ---------------------------------------------------------------------------
# DeepSeek-V2 MLA
# ---------------------------------------------------------------------------

def mla_init(generator, cfg, dtype, device=None):
    m = cfg.mla
    d, H = cfg.d_model, cfg.num_heads
    kw = dict(dtype=dtype, device=device)
    p = {}
    if m.q_lora_rank:
        p["wq_a"] = layers.dense_init(generator, d, m.q_lora_rank, **kw)
        p["q_norm"] = layers.rmsnorm_init(m.q_lora_rank, **kw)
        p["wq_b"] = layers.dense_init(generator, m.q_lora_rank,
                                      H * m.qk_head_dim, **kw)
    else:
        p["wq"] = layers.dense_init(generator, d, H * m.qk_head_dim, **kw)
    p["wkv_a"] = layers.dense_init(generator, d,
                                   m.kv_lora_rank + m.qk_rope_head_dim, **kw)
    p["kv_norm"] = layers.rmsnorm_init(m.kv_lora_rank, **kw)
    p["wk_b"] = layers.dense_init(generator, m.kv_lora_rank,
                                  H * m.qk_nope_head_dim, **kw)
    p["wv_b"] = layers.dense_init(generator, m.kv_lora_rank,
                                  H * m.v_head_dim, **kw)
    p["wo"] = layers.dense_init(generator, H * m.v_head_dim, d, **kw)
    return p


def mla_param_count(cfg) -> int:
    m = cfg.mla
    d, H = cfg.d_model, cfg.num_heads
    n = 0
    if m.q_lora_rank:
        n += (d * m.q_lora_rank + m.q_lora_rank
              + m.q_lora_rank * H * m.qk_head_dim)
    else:
        n += d * H * m.qk_head_dim
    n += d * (m.kv_lora_rank + m.qk_rope_head_dim) + m.kv_lora_rank
    n += m.kv_lora_rank * H * (m.qk_nope_head_dim + m.v_head_dim)
    n += H * m.v_head_dim * d
    return n


def mla_make_cache(cfg, batch: int, max_len: int, dtype, device=None):
    m = cfg.mla
    W = min(max_len, cfg.sliding_window) if cfg.sliding_window else max_len
    return {"c_kv": torch.zeros((batch, W, m.kv_lora_rank), dtype=dtype,
                                device=device),
            "k_rope": torch.zeros((batch, W, m.qk_rope_head_dim),
                                  dtype=dtype, device=device)}


def _mla_q(p, cfg, x):
    m = cfg.mla
    B, S, _ = x.shape
    if m.q_lora_rank:
        cq = layers.rmsnorm(p["q_norm"], layers.dense(p["wq_a"], x),
                            cfg.norm_eps)
        q = layers.dense(p["wq_b"], cq)
    else:
        q = layers.dense(p["wq"], x)
    q = q.reshape(B, S, cfg.num_heads, m.qk_head_dim)
    return q[..., :m.qk_nope_head_dim], q[..., m.qk_nope_head_dim:]


def _bmm_f32(a, b):
    """a (n, i, k) @ b (n, k, j) as an fp32 result.  On the card a bf16
    pair enters one product with an fp32 output, strided views read in
    place (so no fp32 copy of a cache is made); elsewhere the operands are
    upcast, which is exact."""
    if a.device.type == "cuda" and a.dtype != torch.float32:
        return torch.bmm(a, b, out_dtype=torch.float32)
    return torch.bmm(a.float(), b.float())


def mla_apply(p, cfg, x, positions, *, mode: str, cache=None,
              cache_len=None):
    """MLA.  Prefill and train expand the compressed kv and attend over q,
    k (nope + rope) and v padded to the qk head dim (prefill by
    `ops.attention`, train by `blockwise_attention`, which returns no
    cache); decode runs in the compressed space by weight absorption,
    against a cache of c_kv and the shared rope key (kv_lora_rank +
    qk_rope_head_dim a token).  Returns (y, new_cache)."""
    m = cfg.mla
    B, S, d = x.shape
    H = cfg.num_heads
    q_nope, q_rope = _mla_q(p, cfg, x)
    q_rope = layers.apply_rope(q_rope, positions, cfg.rope_theta)

    kv_a = layers.dense(p["wkv_a"], x)
    c_kv = layers.rmsnorm(p["kv_norm"], kv_a[..., :m.kv_lora_rank],
                          cfg.norm_eps)
    k_rope = kv_a[..., m.kv_lora_rank:][:, :, None, :]    # one shared head
    k_rope = layers.apply_rope(k_rope, positions, cfg.rope_theta)[:, :, 0]
    scale = 1.0 / math.sqrt(m.qk_head_dim)

    if mode == "decode":
        if cache is None or S != 1:
            raise ValueError("decode takes one token and a cache")
        if not isinstance(cache_len, torch.Tensor):
            cache_len = torch.full((), int(cache_len), dtype=torch.int64,
                                   device=x.device)
        c_cache, r_cache = cache["c_kv"], cache["k_rope"]
        W = c_cache.shape[1]
        slot = torch.remainder(cache_len, W) if cfg.sliding_window \
            else cache_len
        # the reference writes first and attends over the written cache
        at = slot.reshape(1)
        c_cache.index_copy_(1, at, c_kv.to(c_cache.dtype))
        r_cache.index_copy_(1, at, k_rope.to(r_cache.dtype))
        n_valid = torch.clamp(cache_len + 1, max=W)
        cdt = c_cache.dtype
        # weight absorption: q_nope through wk_b into the rank-kv_lora
        # space, (H, B, nope) x (H, nope, rank) -> (H, B, rank), fp32
        wk_b = p["wk_b"]["w"].reshape(m.kv_lora_rank, H, m.qk_nope_head_dim)
        q_abs = _bmm_f32(q_nope[:, 0].transpose(0, 1), wk_b.permute(1, 2, 0))
        # scores (B, H, W): both products read the caches in place
        s = (_bmm_f32(q_abs.transpose(0, 1).to(cdt), c_cache.transpose(1, 2))
             + _bmm_f32(q_rope[:, 0].to(cdt), r_cache.transpose(1, 2))
             ) * scale
        valid = torch.arange(W, device=x.device) < n_valid
        s = torch.where(valid, s, torch.full_like(s, NEG_INF))
        w = torch.softmax(s, dim=-1)
        ctx = _bmm_f32(w.to(cdt), c_cache)                  # (B, H, rank)
        # ctx and wv_b in fp32: (H, B, rank) x (H, rank, v) -> (H, B, v)
        wv_b = p["wv_b"]["w"].reshape(m.kv_lora_rank, H, m.v_head_dim)
        out = torch.bmm(ctx.transpose(0, 1), wv_b.float().transpose(0, 1))
        out = out.transpose(0, 1).to(x.dtype).reshape(B, S, H * m.v_head_dim)
    elif mode in ("prefill", "train"):
        k_nope = layers.dense(p["wk_b"], c_kv).reshape(
            B, S, H, m.qk_nope_head_dim)
        v = layers.dense(p["wv_b"], c_kv).reshape(B, S, H, m.v_head_dim)
        k_rope_b = k_rope[:, :, None, :].expand(B, S, H, m.qk_rope_head_dim)
        q = torch.cat([q_nope, q_rope], dim=-1)
        k = torch.cat([k_nope, k_rope_b], dim=-1)
        # v padded up to the qk head dim: one attention call (the kernel's
        # scale 1/sqrt(Dh) is then MLA's 1/sqrt(qk_head_dim)); the padded
        # columns are trimmed, so their gradient is zero
        v_pad = F.pad(v, (0, m.qk_head_dim - m.v_head_dim))
        if mode == "train":
            out = blockwise_attention(q, k, v_pad, causal=True,
                                      window=cfg.sliding_window, scale=scale,
                                      block_q=cfg.attn_block_q or 512,
                                      block_k=cfg.attn_block_k or 512)
        else:
            out = ops.attention(q, k, v_pad, causal=True,
                                window=cfg.sliding_window)
        out = out[..., :m.v_head_dim].reshape(B, S, H * m.v_head_dim)
    else:
        raise ValueError(f"attention mode {mode!r}: one of train, prefill, "
                         f"decode")
    new_cache = None
    if mode == "prefill":
        W = min(S, cfg.sliding_window) if cfg.sliding_window else S
        cc, rc = c_kv[:, S - W:], k_rope[:, S - W:]
        if cfg.sliding_window and S > W:
            shift = (S - W) % W          # ring alignment (see gqa_apply)
            cc = torch.roll(cc, shift, dims=1)
            rc = torch.roll(rc, shift, dims=1)
        new_cache = {"c_kv": cc.contiguous(), "k_rope": rc.contiguous()}
    elif mode == "decode":
        new_cache = cache
    y = layers.dense(p["wo"], out)
    return y, new_cache


# ---------------------------------------------------------------------------
# Unified front
# ---------------------------------------------------------------------------

def attn_init(generator, cfg, dtype, device=None):
    f = mla_init if cfg.use_mla else gqa_init
    return f(generator, cfg, dtype, device)


def attn_param_count(cfg) -> int:
    return mla_param_count(cfg) if cfg.use_mla else gqa_param_count(cfg)


def attn_make_cache(cfg, batch: int, max_len: int, dtype, device=None):
    f = mla_make_cache if cfg.use_mla else gqa_make_cache
    return f(cfg, batch, max_len, dtype, device)


def attn_apply(p, cfg, x, positions, *, mode: str, cache=None,
               cache_len=None):
    f = mla_apply if cfg.use_mla else gqa_apply
    return f(p, cfg, x, positions, mode=mode, cache=cache,
             cache_len=cache_len)
