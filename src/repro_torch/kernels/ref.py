"""Plain PyTorch versions of the kernels.

Reference: src/repro/kernels/ref.py (`QUANT_RANGE`, `quantize_value`,
`cutlayer_fwd_ref`, `cutlayer_bwd_ref`, `cutlayer_prior_fwd_ref`,
`cutlayer_prior_bwd_ref`, and the packed wire: `vals_per_word`,
`packed_width`, `quantize_index`, `dequantize_index`, `pack_indices`,
`unpack_indices`, `pack_values_ref`, `unpack_dequant_ref`,
`cutlayer_pack_fwd_ref`), in the same fp32 order.  CPU tensors take these
in place of the CUDA kernels (kernels/inl_bottleneck.py), and chip_smoke.py
holds each kernel against them on the card.  They repeat the kernels' fp32
arithmetic step for step and are no yardstick of speed.
`cutlayer_prior_bwd_sums_ordered` sums the prior gradients in the order of
the CUDA kernel, not of the reference, for the tests' bit-for-bit check.

The LLM stack's: `attention_ref` (the flash-attention kernel's function),
`flash_bwd_ref` (its backward's, from the saved lse),
`ssd_chunked_ref` (the SSD scan kernel's: the port of the JAX model's
`_ssd_chunked`, with its final state) and `ssd_scan_ref` (the sequential
definition of the scan, for the tests).  The multi-tensor AdamW's
(csrc/adamw.cu, no TPU kernel): `grad_norm_ref` (from `global_norm_ref`
and `clip_scale_ref`) and `adamw_update_ref_`, in place, leaf by leaf
through `adamw_leaf_ref`; `optim`'s norm, clip and functional AdamW
update are these same functions.

Modes: "sample" (the paper's eq.-(6) estimator at the quantized latent),
"analytic" (closed-form Gaussian KL) and "none" (rate == 0, the
deterministic cut: with eps == 0, u == quantize(mu)).

The packed wire carries b-bit codeword indices, 32 // b of them in each
uint32 lane, little-endian (codeword k of a lane at bit k*b), the tail of
the last lane zero.  PyTorch has no shifts or sums for torch.uint32, so the
codewords here are int64 and the lanes are assembled in int64 and stored
as torch.uint32, bit for bit the reference's np.uint32 lanes.  Every
function also runs on meta tensors, which is how the wire's byte counts
are sized (core/wirefmt.shipped_nbytes).
"""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

QUANT_RANGE = 4.0   # Gaussian bottlenecks: 4 sigma covers the latents


def quantize_value(u, bits: int, *, u_range: float = QUANT_RANGE):
    """Value map of the uniform link quantizer (no gradient semantics).

    bits >= 32 is the identity (full-precision link).  Rounds half to even
    (torch.round, as jnp.round).  The dequantize divides by a 0-dim tensor,
    not a Python float: PyTorch's CUDA division by a host scalar multiplies
    by its reciprocal, which is not the reference's true division."""
    if bits >= 32:
        return u
    levels = (1 << bits) - 1
    scale = levels / (2.0 * u_range)
    clipped = torch.clamp(u, -u_range, u_range)
    idx = torch.round((clipped + u_range) * scale)
    return idx / torch.full((), scale, dtype=u.dtype, device=u.device) \
        - u_range


def _rate(u, muf, lv, mode: str):
    """The per-row rate of a mode at the fp32 quantized latent u."""
    if mode == "sample":
        return 0.5 * torch.sum(u * u - (u - muf) ** 2 * torch.exp(-lv) - lv,
                               dim=-1)
    if mode == "analytic":
        return 0.5 * torch.sum(torch.exp(lv) + muf * muf - 1.0 - lv, dim=-1)
    return torch.zeros(u.shape[:-1], dtype=torch.float32, device=u.device)


def cutlayer_fwd_ref(mu, logvar, eps, bits: int, mode: str):
    """Fused cut-layer forward, (R, d) rows -> (u (R, d) in mu.dtype,
    rate (R,) fp32), in the fp32 arithmetic order of the kernel."""
    muf = mu.to(torch.float32)
    lv = logvar.to(torch.float32)
    sigma = torch.exp(0.5 * lv)
    pre = muf + sigma * eps.to(torch.float32)
    u = quantize_value(pre, bits)
    return u.to(mu.dtype), _rate(u, muf, lv, mode)


# ---------------------------------------------------------------------------
# Packed wire format: b-bit codeword indices in uint32 lanes
# ---------------------------------------------------------------------------

def vals_per_word(bits: int) -> int:
    """Codewords per uint32 lane (16 at 2 bits, 4 at 8; 10 at the odd 3-bit
    width, whose lanes then carry 2 bits of padding)."""
    if not 1 <= bits <= 16:
        raise ValueError(f"packable link_bits must be in [1, 16], got {bits}")
    return 32 // bits


def packed_width(d: int, bits: int) -> int:
    """uint32 lanes per d-vector: ceil(d / vals_per_word)."""
    return -(-d // vals_per_word(bits))


def _index_scale(bits: int, u_range: float) -> float:
    return ((1 << bits) - 1) / (2.0 * u_range)


def quantize_index(u, bits: int, *, u_range: float = QUANT_RANGE):
    """Codeword index of the uniform link quantizer, int64 in [0, 2^bits).

    `dequantize_index(quantize_index(u, bits), bits)` is
    `quantize_value(u, bits)` bit for bit (the same fp32 expression)."""
    clipped = torch.clamp(u.to(torch.float32), -u_range, u_range)
    return torch.round((clipped + u_range)
                       * _index_scale(bits, u_range)).to(torch.int64)


def dequantize_index(idx, bits: int, *, dtype=torch.float32,
                     u_range: float = QUANT_RANGE):
    """Value of a codeword index: the fusion node's side of the link.  A
    true division by the fp32 scale, as the kernels divide."""
    scale = torch.full((), _index_scale(bits, u_range), dtype=torch.float32,
                       device=idx.device)
    return (idx.to(torch.float32) / scale - u_range).to(dtype)


def pack_indices(idx, bits: int):
    """(..., d) codewords -> (..., W) torch.uint32 lanes, little-endian
    within the lane (codeword k at bit offset k*bits), the tail zero."""
    vpw = vals_per_word(bits)
    d = idx.shape[-1]
    W = packed_width(d, bits)
    idx = torch.nn.functional.pad(idx.to(torch.int64), (0, W * vpw - d))
    grouped = idx.reshape(idx.shape[:-1] + (W, vpw))
    shifts = torch.arange(vpw, dtype=torch.int64, device=idx.device) * bits
    lanes = torch.sum(grouped << shifts, dim=-1)          # in [0, 2^32)
    # int64 -> uint32 through int32 (two's complement), which every device
    # converts; the bits are the lane's
    lanes = torch.where(lanes >= 1 << 31, lanes - (1 << 32), lanes)
    return lanes.to(torch.int32).view(torch.uint32)


def unpack_indices(packed, d: int, bits: int):
    """Inverse of pack_indices: (..., W) uint32 lanes -> (..., d) int64
    codewords."""
    vpw = vals_per_word(bits)
    lanes = packed.view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    shifts = torch.arange(vpw, dtype=torch.int64,
                          device=packed.device) * bits
    ext = (lanes[..., None] >> shifts) & ((1 << bits) - 1)   # (..., W, vpw)
    return ext.reshape(packed.shape[:-1] + (-1,))[..., :d]


def pack_values_ref(u, bits: int):
    """Quantized values -> packed codeword lanes; lossless for u on the
    `bits`-bit grid (any cut-layer output with link_bits == bits)."""
    return pack_indices(quantize_index(u, bits), bits)


def unpack_dequant_ref(packed, d: int, bits: int, *, dtype=torch.float32):
    """Packed codeword lanes -> dense quantized values in `dtype`."""
    return dequantize_index(unpack_indices(packed, d, bits), bits,
                            dtype=dtype)


def cutlayer_pack_fwd_ref(mu, logvar, eps, bits: int, mode: str):
    """Pack-emitting fused forward, (R, d) rows -> (u (R, d) in mu.dtype,
    packed (R, W) uint32, rate (R,) fp32).  The codeword index is the
    shared intermediate (u == dequantize_index(idx)), so (u, rate) equal
    `cutlayer_fwd_ref`'s bit for bit.  Needs 1 <= bits <= 16."""
    muf = mu.to(torch.float32)
    lv = logvar.to(torch.float32)
    sigma = torch.exp(0.5 * lv)
    pre = muf + sigma * eps.to(torch.float32)
    idx = quantize_index(pre, bits)
    u = dequantize_index(idx, bits)
    return u.to(mu.dtype), pack_indices(idx, bits), _rate(u, muf, lv, mode)


def cutlayer_bwd_ref(mu, logvar, eps, gu, grate, bits: int, mode: str):
    """Fused backward (the paper's eq.-(10) split), (R, d) rows.

    Residuals (mu, logvar, eps), cotangents gu (R, d) — the decoder's
    error-vector chunk, passed straight through the quantizer — and grate
    (R,) on the rate.  With w = (u - mu) exp(-logvar):

      sample:   dmu  = gu + grate * u
                dlv  = (gu + grate*(u - w)) * eps*sigma/2
                       + grate * ((u-mu)^2 exp(-lv) - 1) / 2
                deps = (gu + grate*(u - w)) * sigma
      analytic: dmu  = gu + grate * mu
                dlv  = gu * eps*sigma/2 + grate * (exp(lv) - 1) / 2
                deps = gu * sigma
      none:     dmu  = gu;  dlv = gu * eps*sigma/2;  deps = gu * sigma

    Returns (dmu, dlv, deps) in the dtypes of (mu, logvar, eps)."""
    muf = mu.to(torch.float32)
    lv = logvar.to(torch.float32)
    ef = eps.to(torch.float32)
    sigma = torch.exp(0.5 * lv)
    gu = gu.to(torch.float32)
    gr = grate.to(torch.float32)[..., None]
    if mode == "sample":
        u = quantize_value(muf + sigma * ef, bits)
        w = (u - muf) * torch.exp(-lv)
        g_pre = gu + gr * (u - w)
        dmu = gu + gr * u
        dlv = g_pre * (0.5 * sigma * ef) + gr * 0.5 * (w * (u - muf) - 1.0)
        deps = g_pre * sigma
    elif mode == "analytic":
        dmu = gu + gr * muf
        dlv = gu * (0.5 * sigma * ef) + gr * 0.5 * (torch.exp(lv) - 1.0)
        deps = gu * sigma
    else:
        dmu = gu
        dlv = gu * (0.5 * sigma * ef)
        deps = gu * sigma
    return dmu.to(mu.dtype), dlv.to(logvar.dtype), deps.to(eps.dtype)


def cutlayer_prior_fwd_ref(mu, logvar, eps, pmu, plv, bits: int, mode: str):
    """Learned-prior fused forward.  mu/logvar/eps (J, T, d); pmu/plv (J, d)
    per-node prior mean / log-variance.  Returns (u (J, T, d) in mu.dtype,
    rate (J, T) fp32), the sample mode's rate at the quantized u."""
    muf = mu.to(torch.float32)
    lv = logvar.to(torch.float32)
    pm = pmu.to(torch.float32)[:, None, :]
    pv = plv.to(torch.float32)[:, None, :]
    sigma = torch.exp(0.5 * lv)
    pre = muf + sigma * eps.to(torch.float32)
    u = quantize_value(pre, bits)
    if mode == "sample":
        rate = 0.5 * torch.sum((u - pm) ** 2 * torch.exp(-pv) + pv
                               - (u - muf) ** 2 * torch.exp(-lv) - lv, dim=-1)
    else:                                   # "analytic"
        rate = 0.5 * torch.sum(pv - lv + (torch.exp(lv) + (muf - pm) ** 2)
                               * torch.exp(-pv) - 1.0, dim=-1)
    return u.to(mu.dtype), rate


def cutlayer_prior_bwd_ref(mu, logvar, eps, pmu, plv, u, gu, grate,
                           bits: int, mode: str):
    """Learned-prior backward: the eq.-(10) split against Q_psi =
    N(pmu, exp(plv)), from the SAVED quantized forward output u.  With
    wq = (u - pmu) exp(-plv) and w = (u - mu) exp(-lv):

      sample:   g_pre = gu + grate * (wq - w)
                dmu   = g_pre + grate * w            (== gu + grate * wq)
                dlv   = g_pre * eps*sigma/2 + grate * (w*(u-mu) - 1)/2
                deps  = g_pre * sigma
                dpmu  = -sum_rows grate * wq
                dplv  =  sum_rows grate * (1 - wq*(u-pmu))/2
      analytic: with dm = (mu - pmu) * exp(-plv):
                dmu   = gu + grate * dm
                dlv   = gu * eps*sigma/2 + grate * (exp(lv-plv) - 1)/2
                deps  = gu * sigma
                dpmu  = -sum_rows grate * dm
                dplv  =  sum_rows grate
                         * (1 - (exp(lv)+(mu-pmu)^2) exp(-plv))/2

    Rows (J, T, d), priors (J, d); the prior gradients reduce over each
    node's T rows.  Returns (dmu, dlv, deps, dpmu, dplv) in the dtypes of
    (mu, logvar, eps, pmu, plv)."""
    muf = mu.to(torch.float32)
    lv = logvar.to(torch.float32)
    ef = eps.to(torch.float32)
    pm = pmu.to(torch.float32)[:, None, :]
    pv = plv.to(torch.float32)[:, None, :]
    u = u.to(torch.float32)
    sigma = torch.exp(0.5 * lv)
    gu = gu.to(torch.float32)
    gr = grate.to(torch.float32)[..., None]
    if mode == "sample":
        w = (u - muf) * torch.exp(-lv)
        wq = (u - pm) * torch.exp(-pv)
        g_pre = gu + gr * (wq - w)
        dmu = g_pre + gr * w
        dlv = g_pre * (0.5 * sigma * ef) + gr * 0.5 * (w * (u - muf) - 1.0)
        deps = g_pre * sigma
        c = gr * wq
        dpmu = -torch.sum(c, dim=1)
        dplv = 0.5 * (torch.sum(gr, dim=1) - torch.sum(c * (u - pm), dim=1))
    else:                                   # "analytic"
        dm = (muf - pm) * torch.exp(-pv)
        dmu = gu + gr * dm
        e_lp = torch.exp(lv - pv)
        dlv = gu * (0.5 * sigma * ef) + gr * 0.5 * (e_lp - 1.0)
        deps = gu * sigma
        c = gr * dm
        dpmu = -torch.sum(c, dim=1)
        # (exp(lv) + (mu-pm)^2) e^{-pv} == e_lp + dm*(mu-pm)
        dplv = 0.5 * (torch.sum(gr, dim=1) - torch.sum(gr * e_lp, dim=1)
                      - torch.sum(c * (muf - pm), dim=1))
    return (dmu.to(mu.dtype), dlv.to(logvar.dtype), deps.to(eps.dtype),
            dpmu.to(pmu.dtype), dplv.to(plv.dtype))


# The geometry of csrc/cut_prior_bwd.cu, which fixes the order of its sums:
# its kWarps and kTileCols (the tests read the .cu file and hold these to
# them), and the blocks of a large call, which the wrapper passes to it.
PRIOR_BWD_ROWS = 8              # rows of a chunk, one for each warp
PRIOR_BWD_TILE = 64             # columns of a block
PRIOR_BWD_TARGET_BLOCKS = 264   # blocks of a large call: 2 an SM on 132


def prior_bwd_blocks(J: int, T: int, d: int) -> int:
    """The blocks each (node, column tile) takes in cut_prior_bwd's grid:
    min(chunks of PRIOR_BWD_ROWS rows, ceil(target / (J * tiles)))."""
    chunks = -(-T // PRIOR_BWD_ROWS)
    tiles = -(-d // PRIOR_BWD_TILE)
    return min(chunks, -(-PRIOR_BWD_TARGET_BLOCKS // (J * tiles)))


def cutlayer_prior_bwd_sums_ordered(mu, logvar, pmu, plv, u, grate,
                                    mode: str):
    """(dpmu, dplv) fp32 of the learned-prior backward, summed in the CUDA
    kernel's partition and order, every fp32 add a separate torch op, so
    that on the card they equal the kernel's bit for bit (tests and
    chip_smoke.py only; `cutlayer_prior_bwd_ref` is the definition).

    The kernel (csrc/cut_prior_bwd.cu): node j's rows fall into chunks of
    PRIOR_BWD_ROWS; with nb = prior_bwd_blocks(J, T, d), block b takes
    chunks b, b + nb, ..., its warp w row w of each, and adds that row's
    terms, chunk after chunk, from 0; the block adds its warps' sums in
    warp order, from 0; the node's nb block sums are added in block order,
    from 0.  Rows past T add a zero, which leaves a sum that starts at +0
    unchanged."""
    J, T, d = mu.shape
    muf = mu.to(torch.float32)
    lv = logvar.to(torch.float32)
    pm = pmu.to(torch.float32)[:, None, :]
    pv = plv.to(torch.float32)[:, None, :]
    gr = grate.to(torch.float32)[..., None].expand(J, T, d)
    if mode == "sample":
        upm = u.to(torch.float32) - pm
        c = gr * (upm * torch.exp(-pv))
        terms = (gr, c, c * upm, torch.zeros_like(c))
    else:                                   # "analytic"
        mpm = muf - pm
        c = gr * (mpm * torch.exp(-pv))
        terms = (gr, c, gr * torch.exp(lv - pv), c * mpm)
    nb = prior_bwd_blocks(J, T, d)
    rows = PRIOR_BWD_ROWS
    steps = -(-T // (rows * nb))            # chunks a block takes, at most
    terms = torch.nn.functional.pad(torch.stack(terms),
                                    (0, 0, 0, steps * nb * rows - T))
    terms = terms.reshape(4, J, steps, nb, rows, d)
    acc = torch.zeros((4, J, nb, rows, d), dtype=torch.float32,
                      device=mu.device)
    for i in range(steps):                  # chunk order
        acc = acc + terms[:, :, i]
    block = torch.zeros((4, J, nb, d), dtype=torch.float32, device=mu.device)
    for w in range(rows):                   # warp order
        block = block + acc[:, :, :, w]
    s = torch.zeros((4, J, d), dtype=torch.float32, device=mu.device)
    for b in range(nb):                     # block order
        s = s + block[:, :, b]
    return -s[1], 0.5 * ((s[0] - s[2]) - s[3])


# ---------------------------------------------------------------------------
# The LLM stack: attention and the SSD scan
# ---------------------------------------------------------------------------

NEG_INF = -1e30


def attention_ref(q, k, v, *, causal: bool = True, window: int = 0,
                  q_offset: int = 0, lse: bool = False, scale=None):
    """Masked softmax attention, in fp32.  q: (B, Sq, H, Dh); k, v:
    (B, Sk, KV, Dh) with H % KV == 0, query head h reading kv head
    h // (H / KV) (by a reshape, no copy).  q_offset is the position of
    q[0] minus k[0]; window > 0 keeps keys with q_pos - k_pos < window.
    Masked scores are -1e30.  The scores are scale q.k, scale None meaning
    1/sqrt(Dh).  Returns (B, Sq, H, Dh) in q's dtype, or
    with lse=True (out, the logsumexp of each row's masked fp32 scores
    (B, Sq, H)).  float64 inputs are computed in float64 (the gradient
    checks of the attention backward)."""
    B, Sq, H, Dh = q.shape
    _, Sk, KV, _ = k.shape
    g = H // KV
    if scale is None:
        scale = 1.0 / float(np.sqrt(Dh))
    acc = torch.promote_types(q.dtype, torch.float32)
    qf = (q.to(acc) * scale).reshape(B, Sq, KV, g, Dh)
    s = torch.einsum("bqkgd,btkd->bkgqt", qf, k.to(acc))
    q_pos = torch.arange(Sq, device=q.device)[:, None] + q_offset
    k_pos = torch.arange(Sk, device=q.device)[None, :]
    mask = torch.ones((Sq, Sk), dtype=torch.bool, device=q.device)
    if causal:
        mask = mask & (k_pos <= q_pos)
    if window:
        mask = mask & (q_pos - k_pos < window)
    s = torch.where(mask, s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgqt,btkd->bqkgd", p, v.to(acc))
    out = out.reshape(B, Sq, H, Dh).to(q.dtype)
    if not lse:
        return out
    # (B, KV, g, Sq) -> (B, Sq, KV * g)
    return out, torch.logsumexp(s, dim=-1).permute(0, 3, 1, 2).reshape(
        B, Sq, H)


def _mask_for(q_pos, k_pos, Sk, *, causal, window):
    mask = k_pos[None, :] < Sk
    if causal:
        mask = mask & (k_pos[None, :] <= q_pos[:, None])
    if window:
        mask = mask & (q_pos[:, None] - k_pos[None, :] < window)
    return mask


def flash_bwd_ref(q, k, v, out, lse, dout, *, causal, window, q_offset,
                  block_q, block_k, scale=None):
    """The attention backward's plain version (the kernel is
    csrc/flash_attn_bwd.cu): the reference's `_flash_bwd`, doubly blocked:
    key tiles outer (each
    emitting its dk, dv tile), query tiles inner (adding into a full-size
    fp32 dq), in fp32; ragged tiles padded with zeros as the reference
    pads them, GQA's kv gradients summed over the group axis.  A tile that
    the causal mask or the window hides whole is skipped: its p is
    exp(-1e30 - lse) = 0, so the reference adds exact zeros there.
    q, out, dout: (B, Sq, H, Dh); k, v: (B, Sk, KV, Dh); lse: (B, Sq, H)
    fp32 (float64 inputs stay float64, for gradcheck); scale the
    forward's (None: 1/sqrt(Dh)).  Returns (dq, dk, dv) in q's, k's and
    v's dtypes."""
    B, Sq, H, Dh = q.shape
    _, Sk, KV, _ = k.shape
    g = H // KV
    if scale is None:
        scale = 1.0 / math.sqrt(Dh)
    bq, bk = min(block_q, Sq), min(block_k, Sk)
    nq, nk = -(-Sq // bq), -(-Sk // bk)
    qpad, kpad = nq * bq - Sq, nk * bk - Sk
    acc = torch.promote_types(q.dtype, torch.float32)
    do = dout.to(acc).reshape(B, Sq, KV, g, Dh)
    delta = torch.sum(do * out.to(acc).reshape(B, Sq, KV, g, Dh), dim=-1)
    qf = q.to(acc).reshape(B, Sq, KV, g, Dh)
    lse = lse.to(acc).reshape(B, Sq, KV, g)
    if qpad:
        qf, do = F.pad(qf, (0, 0, 0, 0, 0, 0, 0, qpad)), \
            F.pad(do, (0, 0, 0, 0, 0, 0, 0, qpad))
        delta = F.pad(delta, (0, 0, 0, 0, 0, qpad))
        lse = F.pad(lse, (0, 0, 0, 0, 0, qpad))
    kf, vf = k.to(acc), v.to(acc)
    if kpad:
        kf = F.pad(kf, (0, 0, 0, 0, 0, kpad))
        vf = F.pad(vf, (0, 0, 0, 0, 0, kpad))
    dq = qf.new_zeros((B, nq * bq, KV, g, Dh))
    dk = kf.new_zeros((B, nk * bk, KV, Dh))
    dv = kf.new_zeros((B, nk * bk, KV, Dh))
    ar_q = torch.arange(bq, device=q.device)
    ar_k = torch.arange(bk, device=q.device)
    for ki in range(nk):
        k0 = ki * bk
        kc, vc = kf[:, k0:k0 + bk], vf[:, k0:k0 + bk]
        k_pos = k0 + ar_k
        dk_acc, dv_acc = dk[:, k0:k0 + bk], dv[:, k0:k0 + bk]
        for qi in range(nq):
            q0 = qi * bq
            if causal and q0 + bq - 1 + q_offset < k0:
                continue                     # above the diagonal
            if window and q0 + q_offset - (k0 + bk - 1) >= window:
                continue                     # behind the window
            sl = slice(q0, q0 + bq)
            qc, doc, dc, lc = qf[:, sl], do[:, sl], delta[:, sl], lse[:, sl]
            q_pos = q0 + ar_q + q_offset
            s = torch.einsum("bqkgd,btkd->bqkgt", qc, kc) * scale
            mask = _mask_for(q_pos, k_pos, Sk, causal=causal, window=window)
            s = torch.where(mask[None, :, None, None, :], s,
                            torch.full_like(s, NEG_INF))
            p = torch.exp(s - lc[..., None])
            dv_acc += torch.einsum("bqkgt,bqkgd->btkd", p, doc)
            dp = torch.einsum("bqkgd,btkd->bqkgt", doc, vc)
            ds = p * (dp - dc[..., None])
            dq[:, sl] += torch.einsum("bqkgt,btkd->bqkgd", ds, kc) * scale
            dk_acc += torch.einsum("bqkgt,bqkgd->btkd", ds, qc) * scale
    return (dq[:, :Sq].reshape(B, Sq, H, Dh).to(q.dtype),
            dk[:, :Sk].to(k.dtype), dv[:, :Sk].to(v.dtype))


def _chunk_cumsum(x, dim: int):
    """The in-chunk cumsum along `dim`.  On the CPU torch.cumsum; on a CUDA
    tensor, where torch.cumsum of floats has no deterministic path (and so
    raises under `torch.use_deterministic_algorithms`, as the launcher and
    the benchmark run), the Hillis-Steele scan: log2(n) shifted adds, each
    deterministic.  The two differ in the last bits, so the CPU keeps
    torch.cumsum, the reference model's operation."""
    if x.device.type != "cuda":
        return torch.cumsum(x, dim=dim)
    n, shift = x.shape[dim], 1
    while shift < n:
        pad = [0, 0] * (x.dim() - 1 - dim % x.dim()) + [shift, 0]
        x = x + F.pad(x.narrow(dim, 0, n - shift), pad)
        shift *= 2
    return x


def _by_group(x, dt, a, bm, cm, dskip):
    """The heads of each group of B and C: yields (x, dt, a, bm, cm, dskip)
    of group g, bm and cm (B, S, N), for g in 0..G-1.  bm, cm: (B, S, N)
    (G = 1) or (B, S, G, N), G dividing H; head h reads group h // (H / G).
    At G = 1 the one group is the inputs themselves."""
    H = x.shape[2]
    if bm.dim() == 3:
        bm, cm = bm[:, :, None], cm[:, :, None]
    G = bm.shape[2]
    if H % G:
        raise ValueError(f"{H} heads do not split into {G} groups of B, C")
    hg = H // G
    for g in range(G):
        h = slice(g * hg, (g + 1) * hg)
        yield (x[:, :, h], dt[:, :, h], a[h], bm[:, :, g], cm[:, :, g],
               dskip[h])


def _join(outs):
    """The groups' (y (B, S, h, P), state (B, h, N, P)) joined along the
    heads.  One group's come back as they are: a cat there would change
    the order of the sums in its backward (dskip's gradient moves by an
    ulp)."""
    if len(outs) == 1:
        return outs[0]
    return (torch.cat([y for y, _ in outs], dim=2),
            torch.cat([st for _, st in outs], dim=1))


def ssd_chunked_ref(x, dt, a, bm, cm, dskip, *, chunk: int):
    """Chunked SSD scan (Mamba2), the port of the reference model's
    `_ssd_chunked` in its fp32 order, with G groups of B and C.

    x: (B, S, H, P); dt: (B, S, H) post-softplus; a: (H,) negative; bm, cm:
    (B, S, N) shared over heads (G = 1), or (B, S, G, N) with G dividing H,
    head h reading group h // (H / G); dskip: (H,).  chunk = min(chunk, S)
    must divide S.  The scan starts from a zero state.  Returns (y (B, S,
    H, P) in x's dtype, final_state (B, H, N, P) fp32).  The groups run one
    after another, each the one-group form over its heads, so C.B^T is
    formed once per (b, chunk, group) and G = 1 is the one-group form
    itself, bit for bit."""
    return _join([_ssd_chunked_group(*grp, chunk=chunk)
                  for grp in _by_group(x, dt, a, bm, cm, dskip)])


def _ssd_chunked_group(x, dt, a, bm, cm, dskip, *, chunk: int):
    """`ssd_chunked_ref` for one group: B and C (B, S, N) shared by every
    head of x."""
    Bsz, S, H, P = x.shape
    N = bm.shape[-1]
    chunk = min(chunk, S)
    nc = S // chunk
    if nc * chunk != S:
        raise ValueError(f"seq {S} not divisible by chunk {chunk}")
    xc = x.reshape(Bsz, nc, chunk, H, P).float()
    dtc = dt.reshape(Bsz, nc, chunk, H).float()
    Bc = bm.reshape(Bsz, nc, chunk, N).float()
    Cc = cm.reshape(Bsz, nc, chunk, N).float()

    dA = dtc * a.float()[None, None, None, :]            # (B,nc,cs,H), <= 0
    cum = _chunk_cumsum(dA, 2)                       # within-chunk cumsum

    # intra-chunk: decay(i <- j) = exp(cum_i - cum_j), j <= i, else 0.
    # The mask goes in before the exp: above the diagonal seg >= 0 is the
    # chunk's whole dt |a| at worst, and past ~88 its exp is inf.  The
    # reference masks after the exp, so its backward's 0 * inf is NaN
    # there; here the same values come out, and the gradients equal the
    # reference's wherever those are finite
    seg = cum[:, :, :, None, :] - cum[:, :, None, :, :]  # (B,nc,i,j,H)
    causal = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool,
                                   device=x.device))
    decay = torch.exp(torch.where(causal[None, None, :, :, None], seg,
                                  torch.full((), -math.inf,
                                             device=x.device)))
    cb = torch.einsum("bcin,bcjn->bcij", Cc, Bc)
    att = cb[..., None] * decay * dtc[:, :, None, :, :]  # weight dt_j
    y_intra = torch.einsum("bcijh,bcjhp->bcihp", att, xc)

    # chunk-final states
    decay_to_end = torch.exp(cum[:, :, -1:, :] - cum)    # (B,nc,cs,H)
    chunk_states = torch.einsum("bcjn,bcjh,bcjhp->bchnp", Bc,
                                decay_to_end * dtc, xc)  # (B,nc,H,N,P)

    # inter-chunk recurrence over the nc chunks
    gamma = torch.exp(cum[:, :, -1, :])                  # (B,nc,H)
    state = torch.zeros((Bsz, H, N, P), device=x.device)
    entering = []
    for c in range(nc):
        entering.append(state)                           # state entering c
        state = state * gamma[:, c, :, None, None] + chunk_states[:, c]
    entering = torch.stack(entering, dim=1)              # (B,nc,H,N,P)

    y_inter = torch.einsum("bcin,bcih,bchnp->bcihp", Cc, torch.exp(cum),
                           entering)
    y = (y_intra + y_inter).reshape(Bsz, S, H, P)
    y = y + dskip.float()[None, None, :, None] * x.float()
    return y.to(x.dtype), state


def ssd_scan_ref(x, dt, a, bm, cm, dskip):
    """The sequential SSM recurrence (the definition, not the chunked
    form): h_t = exp(dt_t a) h_{t-1} + dt_t B_t x_t^T; y_t = C_t h_t + D x_t,
    B_t and C_t those of the head's group.  Shapes as `ssd_chunked_ref`;
    returns (y in x's dtype, final state (B, H, N, P) fp32)."""
    return _join([_ssd_scan_group(*grp)
                  for grp in _by_group(x, dt, a, bm, cm, dskip)])


def _ssd_scan_group(x, dt, a, bm, cm, dskip):
    """`ssd_scan_ref` for one group: B and C (B, S, N) shared by every head
    of x."""
    B, S, H, P = x.shape
    N = bm.shape[-1]
    xf, dtf, bf, cf = x.float(), dt.float(), bm.float(), cm.float()
    h = torch.zeros((B, H, N, P), device=x.device)
    ys = []
    for t in range(S):
        decay = torch.exp(dtf[:, t] * a.float())         # (B,H)
        upd = torch.einsum("bh,bn,bhp->bhnp", dtf[:, t], bf[:, t], xf[:, t])
        h = h * decay[..., None, None] + upd
        ys.append(torch.einsum("bn,bhnp->bhp", cf[:, t], h))
    y = torch.stack(ys, dim=1)
    y = y + dskip.float()[None, None, :, None] * xf
    return y.to(x.dtype), h


# ---------------------------------------------------------------------------
# The multi-tensor AdamW (csrc/adamw.cu): the norm, then the update in place
# ---------------------------------------------------------------------------

def global_norm_ref(leaves):
    """sqrt of the sum of squares of every tensor of `leaves`, in fp32: the
    sums leaf by leaf, then their sum (`optim.global_norm`)."""
    sums = [torch.sum(torch.square(x.to(torch.float32))) for x in leaves]
    if not sums:
        return torch.zeros((), dtype=torch.float32)
    return torch.sqrt(torch.sum(torch.stack(sums)))


def clip_scale_ref(norm, max_norm: float):
    """min(1, max_norm / max(norm, 1e-9)), a tensor like `norm`."""
    return torch.clamp(torch.full_like(norm, max_norm)
                       / torch.clamp(norm, min=1e-9), max=1.0)


def grad_norm_ref(grads, max_norm):
    """(global norm of the list `grads` in fp32, clip scale): 1 where
    max_norm is None or 0."""
    norm = global_norm_ref(grads)
    if not max_norm:
        return norm, torch.ones((), dtype=torch.float32, device=norm.device)
    return norm, clip_scale_ref(norm, max_norm)


def adamw_leaf_ref(g, m, v, w, lr, bc1, bc2, *, b1: float, b2: float,
                   eps: float, weight_decay: float):
    """One leaf of AdamW, the operations the kernel repeats element by
    element: g the clipped gradient, m and v fp32, w the base (the fp32
    master, or the weight itself), lr, bc1 = 1 - b1^t and bc2 = 1 - b2^t
    fp32 0-dim tensors.  Returns the new (m, v, base in fp32)."""
    g = g.to(torch.float32)
    m = b1 * m + (1 - b1) * g
    v = b2 * v + (1 - b2) * torch.square(g)
    w = w.to(torch.float32)
    step = (m / bc1) / (torch.sqrt(v / bc2) + eps)
    if weight_decay:
        step = step + weight_decay * w
    return m, v, w - lr * step


@torch.no_grad()
def adamw_update_ref_(grads, m, v, master, params, scale, lr, bc1, bc2, *,
                      b1: float, b2: float, eps: float,
                      weight_decay: float) -> None:
    """AdamW in place, leaf by leaf (`adamw_leaf_ref`): the gradient times
    `scale` in its own type, then m, v, the master (a list, or None: the
    weight itself) and the weight in its type.  scale, lr, bc1, bc2: fp32
    0-dim tensors."""
    masters = [None] * len(params) if master is None else master
    for g, m_, v_, w_, p in zip(grads, m, v, masters, params):
        new_m, new_v, new = adamw_leaf_ref(
            g * scale.to(g.dtype), m_, v_, p if w_ is None else w_, lr, bc1,
            bc2, b1=b1, b2=b2, eps=eps, weight_decay=weight_decay)
        m_.copy_(new_m)
        v_.copy_(new_v)
        if w_ is not None:
            w_.copy_(new)
        p.copy_(new)
