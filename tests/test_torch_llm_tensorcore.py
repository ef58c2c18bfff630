"""The two numerical choices of the tensor-core (bf16) LLM kernels, pinned
in plain torch on the CPU against the JAX package.

  * `flash_attn_fwd` feeds P to a bf16 P.V (the TPU kernel keeps P in
    fp32: it casts k and v to fp32).  The kernel's algorithm, emulated here
    (64-key tiles, the online softmax in log2 units on fp32 scores, the row
    sum of the unrounded p), matches the Pallas `flash_attention` in
    interpret mode within the fp32 bar with P left in fp32; with P rounded
    to one bf16 within 2^-9 max|v| plus that bar (|dp| <= 2^-9 p, so
    |do| <= 2^-9 sum_j p_j |v_j| / l); and with P split into bf16 hi + lo,
    as the kernel does, within 2^-17 max|v| plus that bar.
  * `ssd_scan` runs the SSD decomposition chunk-parallel in four stages:
    (a) C.B^T once per (b, chunk) in 64 x 64 tiles on or below the
    diagonal, (b) each chunk's own state, (c) the state passed over the
    chunks, (d) the output per 64-row tile.  Emulated here stage by stage,
    it equals `ref.ssd_chunked_ref`, the Pallas `ssd_scan` in interpret
    mode and the model's `_ssd_chunked` at the fp32 bar of
    tests/test_kernels.py (relative to the largest |y|), for chunks 32, 64
    and 96 (ragged against the 64-row tiles); with its bf16 operands (G,
    the weighted B rows, the incoming state) rounded as the kernel rounds
    them, within the bf16 bar.

Inputs are drawn with numpy from a seed and handed to both packages.
"""
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels.flash_attention import flash_attention  # noqa: E402
from repro.kernels.ssm_scan import ssd_scan as jax_ssd_scan  # noqa: E402
from repro.models.ssm import _ssd_chunked  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402

TOL = 2e-5
BF16_TOL = 2e-2
TILE = 64
NEG_INF = -1e30


def bf16(t):
    """t rounded to bf16, kept in fp32."""
    return t.to(torch.bfloat16).float()


def rel_err(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / (np.abs(want).max() + 1e-6))


# ---------------------------------------------------------------------------
# attention: P rounded to bf16
# ---------------------------------------------------------------------------

def split_bf16(p):
    """p as the kernel feeds it to P.V: bf16 hi + bf16 lo."""
    hi = bf16(p)
    return hi + bf16(p - hi)


P_ROUNDINGS = {"fp32": (lambda p: p, 0.0), "bf16": (bf16, 2.0 ** -9),
               "bf16 hi + lo": (split_bf16, 2.0 ** -17)}


def flash_emulated(q, k, v, *, causal, window, q_offset, round_p):
    """The tensor-core kernel's algorithm in fp32: 64-key tiles, scores
    scaled by 1/sqrt(Dh) log2(e) after the product, online softmax in
    log2 units, P passed through `round_p` before P.V, the row sum of the
    unrounded p.  q (B, Sq, H, Dh), k and v (B, Sk, KV, Dh)."""
    B, Sq, H, Dh = q.shape
    _, Sk, KV, _ = k.shape
    g = H // KV
    scale_log2 = (1.0 / math.sqrt(Dh)) * math.log2(math.e)
    qf = q.reshape(B, Sq, KV, g, Dh)
    m = torch.full((B, KV, g, Sq), NEG_INF)
    l = torch.zeros((B, KV, g, Sq))
    acc = torch.zeros((B, KV, g, Sq, Dh))
    q_pos = torch.arange(Sq)[:, None] + q_offset
    for k0 in range(0, Sk, TILE):
        kt, vt = k[:, k0:k0 + TILE], v[:, k0:k0 + TILE]
        s = torch.einsum("bqkgd,btkd->bkgqt", qf, kt) * scale_log2
        k_pos = torch.arange(k0, k0 + kt.shape[1])[None, :]
        keep = torch.ones((Sq, kt.shape[1]), dtype=torch.bool)
        if causal:
            keep = keep & (k_pos <= q_pos)
        if window:
            keep = keep & (q_pos - k_pos < window)
        s = torch.where(keep, s, torch.full_like(s, NEG_INF))
        mn = torch.maximum(m, s.amax(-1))
        corr = torch.exp2(m - mn)
        p = torch.exp2(s - mn[..., None])
        l = l * corr + p.sum(-1)
        acc = acc * corr[..., None] + torch.einsum("bkgqt,btkd->bkgqd",
                                                   round_p(p), vt)
        m = mn
    o = acc / torch.clamp(l, min=1e-30)[..., None]
    return o.permute(0, 3, 1, 2, 4).reshape(B, Sq, H, Dh)


@pytest.mark.parametrize("rounding", list(P_ROUNDINGS))
@pytest.mark.parametrize("q_offset", [0, 64])
@pytest.mark.parametrize("window", [0, 100])
def test_attention_with_bf16_p_matches_pallas_interpret(window, q_offset,
                                                        rounding):
    rng = np.random.default_rng(11)
    B, S, H, KV, Dh = 1, 192, 4, 2, 80
    # bf16 values, as the kernel reads them, carried in fp32
    q, k, v = (bf16(torch.from_numpy(
        rng.normal(size=(B, S, n, Dh)).astype(np.float32)))
        for n in (H, KV, KV))
    q = q[:, q_offset:].contiguous()
    want = np.asarray(flash_attention(
        jnp.asarray(q.numpy()), jnp.asarray(k.numpy()),
        jnp.asarray(v.numpy()), causal=True, window=window,
        q_offset=q_offset, block_q=64, block_k=64, interpret=True))
    round_p, rel = P_ROUNDINGS[rounding]
    got = flash_emulated(q, k, v, causal=True, window=window,
                         q_offset=q_offset, round_p=round_p).numpy()
    bar = rel * float(v.abs().max()) + TOL
    err = float(np.abs(got - want).max())
    assert err <= bar, (err, bar)


# ---------------------------------------------------------------------------
# SSD: the four-stage chunk-parallel decomposition
# ---------------------------------------------------------------------------

def ssd_inputs(B, S, H, P, N, seed):
    """(x, dt, a, bm, cm, d) as tests/test_kernels.py draws them."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(B, S, H, P)).astype(np.float32)
    dt = np.log1p(np.exp(rng.normal(size=(B, S, H)))).astype(np.float32)
    a = (-np.exp(0.2 * rng.normal(size=(H,)))).astype(np.float32)
    bm = rng.normal(size=(B, S, N)).astype(np.float32)
    cm = rng.normal(size=(B, S, N)).astype(np.float32)
    d = (1.0 + 0.2 * rng.normal(size=(H,))).astype(np.float32)
    return x, dt, a, bm, cm, d


def ssd_four_stage(x, dt, a, bm, cm, dskip, *, chunk, rnd=lambda t: t):
    """The bf16 kernel's four stages in fp32; `rnd` is applied where the
    kernel rounds an MMA operand to bf16.  Returns (y, final state)."""
    Bsz, S, H, P = x.shape
    N = bm.shape[-1]
    L = chunk
    nc, T = S // L, -(-L // TILE)
    xc = x.reshape(Bsz, nc, L, H, P)
    dtc = dt.reshape(Bsz, nc, L, H)
    Bc, Cc = bm.reshape(Bsz, nc, L, N), cm.reshape(Bsz, nc, L, N)
    cum = torch.cumsum(dtc * a, dim=2)                    # (B, nc, L, H)
    rows = [(t * TILE, min(L, (t + 1) * TILE)) for t in range(T)]

    # (a) C.B^T once per (b, chunk), tiles it >= jt
    cb = {(it, jt): torch.einsum("bcin,bcjn->bcij", Cc[:, :, i0:i1],
                                 Bc[:, :, j0:j1])
          for it, (i0, i1) in enumerate(rows)
          for jt, (j0, j1) in enumerate(rows[:it + 1])}
    # (b) each chunk's own state, the weight applied to B's rows
    last = cum[:, :, -1]                                  # (B, nc, H)
    w = torch.exp(last[:, :, None] - cum) * dtc           # (B, nc, L, H)
    sc = torch.einsum("bcjhn,bcjhp->bchnp",
                      rnd(Bc[:, :, :, None, :] * w[..., None]), xc)
    # (c) the state passed over the chunks, fp32; S_in rounded
    st = torch.zeros((Bsz, H, N, P))
    s_in = []
    for c in range(nc):
        s_in.append(rnd(st))
        st = st * torch.exp(last[:, c])[..., None, None] + sc[:, c]
    s_in = torch.stack(s_in, dim=1)                       # (B, nc, H, N, P)
    # (d) per 64-row tile: e^{cum_i} C_i S_in + sum_{jt <= it} G x_j + D x
    y = torch.empty_like(xc)
    for it, (i0, i1) in enumerate(rows):
        acc = torch.einsum("bcin,bchnp->bcihp", Cc[:, :, i0:i1], s_in) \
            * torch.exp(cum[:, :, i0:i1])[..., None]
        for jt, (j0, j1) in enumerate(rows[:it + 1]):
            seg = cum[:, :, i0:i1, None, :] - cum[:, :, None, j0:j1, :]
            keep = (torch.arange(j0, j1)[None, :]
                    <= torch.arange(i0, i1)[:, None])[None, None, :, :, None]
            g = torch.where(
                keep, cb[it, jt][..., None]
                * torch.exp(torch.where(keep, seg, torch.zeros(())))
                * dtc[:, :, None, j0:j1, :], torch.zeros(()))
            acc = acc + torch.einsum("bcijh,bcjhp->bcihp", rnd(g),
                                     xc[:, :, j0:j1])
        y[:, :, i0:i1] = acc + dskip[None, None, None, :, None] \
            * xc[:, :, i0:i1]
    return y.reshape(Bsz, S, H, P), st


@pytest.mark.parametrize("N,P", [(8, 16), (8, 64), (64, 16), (64, 64)])
@pytest.mark.parametrize("chunk", [32, 64, 96])
def test_ssd_four_stages_match_reference_and_pallas(chunk, N, P):
    arrays = ssd_inputs(1, 192, 2, P, N, seed=12 + chunk + N + P)
    y, state = ssd_four_stage(*map(torch.from_numpy, arrays), chunk=chunk)
    y_ref, state_ref = ref.ssd_chunked_ref(*map(torch.from_numpy, arrays),
                                           chunk=chunk)
    jargs = tuple(map(jnp.asarray, arrays))
    y_pallas = jax_ssd_scan(*jargs, chunk=chunk, interpret=True)
    y_model, state_model = _ssd_chunked(*jargs, chunk)
    assert rel_err(y.numpy(), y_ref.numpy()) <= TOL
    assert rel_err(y.numpy(), y_pallas) <= TOL
    assert rel_err(y.numpy(), y_model) <= TOL
    assert rel_err(state.numpy(), state_ref.numpy()) <= TOL
    assert rel_err(state.numpy(), state_model) <= TOL


@pytest.mark.parametrize("chunk", [64, 96, 256])
def test_ssd_four_stages_with_bf16_operands_within_the_bf16_bar(chunk):
    """x, B, C as bf16 values (what the kernel reads), G, the weighted B
    rows and the incoming state rounded to bf16 as MMA operands, y rounded
    to bf16 at the end: within the bf16 bar of the fp32 plain version."""
    x, dt, a, bm, cm, d = map(torch.from_numpy,
                              ssd_inputs(1, 768, 2, 64, 64, seed=13))
    x, bm, cm = bf16(x), bf16(bm), bf16(cm)
    y, state = ssd_four_stage(x, dt, a, bm, cm, d, chunk=chunk, rnd=bf16)
    y_ref, state_ref = ref.ssd_chunked_ref(x, dt, a, bm, cm, d, chunk=chunk)
    assert rel_err(bf16(y).numpy(), y_ref.numpy()) <= BF16_TOL
    assert rel_err(state.numpy(), state_ref.numpy()) <= BF16_TOL
