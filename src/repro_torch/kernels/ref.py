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
`ssd_chunked_ref` (the SSD scan kernel's: the port of the JAX model's
`_ssd_chunked`, with its final state) and `ssd_scan_ref` (the sequential
definition of the scan, for the tests).

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

import numpy as np
import torch

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
                  q_offset: int = 0):
    """Masked softmax attention, in fp32.  q: (B, Sq, H, Dh); k, v:
    (B, Sk, KV, Dh) with H % KV == 0, query head h reading kv head
    h // (H / KV) (by a reshape, no copy).  q_offset is the position of
    q[0] minus k[0]; window > 0 keeps keys with q_pos - k_pos < window.
    Masked scores are -1e30.  Returns (B, Sq, H, Dh) in q's dtype."""
    B, Sq, H, Dh = q.shape
    _, Sk, KV, _ = k.shape
    g = H // KV
    scale = 1.0 / float(np.sqrt(Dh))
    qf = (q.float() * scale).reshape(B, Sq, KV, g, Dh)
    s = torch.einsum("bqkgd,btkd->bkgqt", qf, k.float())
    q_pos = torch.arange(Sq, device=q.device)[:, None] + q_offset
    k_pos = torch.arange(Sk, device=q.device)[None, :]
    mask = torch.ones((Sq, Sk), dtype=torch.bool, device=q.device)
    if causal:
        mask = mask & (k_pos <= q_pos)
    if window:
        mask = mask & (q_pos - k_pos < window)
    s = torch.where(mask, s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgqt,btkd->bqkgd", p, v.float())
    return out.reshape(B, Sq, H, Dh).to(q.dtype)


def ssd_chunked_ref(x, dt, a, bm, cm, dskip, *, chunk: int):
    """Chunked SSD scan (Mamba2, ngroups=1), the port of the reference
    model's `_ssd_chunked` in its fp32 order.

    x: (B, S, H, P); dt: (B, S, H) post-softplus; a: (H,) negative; bm, cm:
    (B, S, N) shared over heads; dskip: (H,).  chunk = min(chunk, S) must
    divide S.  The scan starts from a zero state.  Returns (y (B, S, H, P)
    in x's dtype, final_state (B, H, N, P) fp32)."""
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
    cum = torch.cumsum(dA, dim=2)                        # within-chunk cumsum

    # intra-chunk: decay(i <- j) = exp(cum_i - cum_j), j <= i
    seg = cum[:, :, :, None, :] - cum[:, :, None, :, :]  # (B,nc,i,j,H)
    causal = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool,
                                   device=x.device))
    decay = torch.where(causal[None, None, :, :, None], torch.exp(seg),
                        torch.zeros((), device=x.device))
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
    form): h_t = exp(dt_t a) h_{t-1} + dt_t B_t x_t^T; y_t = C_t h_t + D x_t.
    Shapes as `ssd_chunked_ref`; returns (y in x's dtype, final state
    (B, H, N, P) fp32)."""
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
