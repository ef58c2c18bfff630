"""Plain PyTorch versions of the cut-layer kernels.

Reference: src/repro/kernels/ref.py (`QUANT_RANGE`, `quantize_value`,
`cutlayer_fwd_ref`).  CPU tensors take these in place of the CUDA kernels
(kernels/inl_bottleneck.py), and chip_smoke.py holds each kernel against
them on the card.  They repeat the kernels' fp32 arithmetic step for step
and are no yardstick of speed.

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
