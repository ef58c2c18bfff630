"""The cut layer as the paper defines it (eq. 6, §III-C), in plain fp32
torch: the reparametrised sample u = mu + sigma eps, sent over a link of
`bits` bits (a uniform quantizer on [-4, 4], passed straight through by
the gradient; none at 32 bits or more), and the per-sample rate
log P(u | x) - log N(u; 0, I) at the sent u.
"""
from __future__ import annotations

import torch

QUANT_RANGE = 4.0


def quantize(pre, bits: int):
    if bits >= 32:
        return pre
    scale = ((1 << bits) - 1) / (2.0 * QUANT_RANGE)
    q = torch.round((torch.clamp(pre, -QUANT_RANGE, QUANT_RANGE)
                     + QUANT_RANGE) * scale) / scale - QUANT_RANGE
    return pre + (q - pre).detach()


def sample(mu, logvar, eps, bits: int):
    """(u, rate (...,)) from (mu, logvar, eps) (..., d)."""
    u = quantize(mu + torch.exp(0.5 * logvar) * eps, bits)
    rate = 0.5 * torch.sum(u * u - (u - mu) ** 2 * torch.exp(-logvar)
                           - logvar, dim=-1)
    return u, rate
