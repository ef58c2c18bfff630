"""Plain PyTorch versions of the cut-layer kernels.

Reference: src/repro/kernels/ref.py (`QUANT_RANGE`, `quantize_value`,
`cutlayer_fwd_ref`, `cutlayer_bwd_ref`, `cutlayer_prior_fwd_ref`,
`cutlayer_prior_bwd_ref`), in the same fp32 order.  CPU tensors take these
in place of the CUDA kernels (kernels/inl_bottleneck.py), and chip_smoke.py
holds each kernel against them on the card.  They repeat the kernels' fp32
arithmetic step for step and are no yardstick of speed.

Modes: "sample" (the paper's eq.-(6) estimator at the quantized latent),
"analytic" (closed-form Gaussian KL) and "none" (rate == 0, the
deterministic cut: with eps == 0, u == quantize(mu)).
"""
from __future__ import annotations

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
    return idx / torch.tensor(scale, dtype=u.dtype, device=u.device) - u_range


def cutlayer_fwd_ref(mu, logvar, eps, bits: int, mode: str):
    """Fused cut-layer forward, (R, d) rows -> (u (R, d) in mu.dtype,
    rate (R,) fp32), in the fp32 arithmetic order of the kernel."""
    muf = mu.to(torch.float32)
    lv = logvar.to(torch.float32)
    sigma = torch.exp(0.5 * lv)
    pre = muf + sigma * eps.to(torch.float32)
    u = quantize_value(pre, bits)
    if mode == "sample":
        rate = 0.5 * torch.sum(u * u - (u - muf) ** 2 * torch.exp(-lv) - lv,
                               dim=-1)
    elif mode == "analytic":
        rate = 0.5 * torch.sum(torch.exp(lv) + muf * muf - 1.0 - lv, dim=-1)
    else:
        rate = torch.zeros(u.shape[:-1], dtype=torch.float32,
                           device=u.device)
    return u.to(mu.dtype), rate


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
