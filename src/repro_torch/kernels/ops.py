"""Dispatching wrappers for the kernels.

Reference: src/repro/kernels/ops.py (`cutlayer`).  The JAX package picks an
implementation with `backend="auto"|"pallas"|"reference"`; here the device
of the tensors decides, and nothing else: a CPU tensor takes the plain
version, a CUDA tensor the hand-written kernel or an exception.  There is no
setting that sends a CUDA tensor to the plain version.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import inl_bottleneck as _bn


def cutlayer(mu, logvar, eps, *, link_bits: int = 32,
             rate_estimator: str = "sample", prior_mu=None,
             prior_logvar=None):
    """Fused cut layer: (u_quantized, per-row rate) in one kernel pass, the
    hand-written eq.-(10) backward under autograd.  mu/logvar/eps: (..., d)
    with all leading axes (clients, batch) folded into the rows — one
    launch for all J nodes.  rate_estimator "none" zeroes the rate (the
    deterministic cut); prior_mu/prior_logvar — (d,) shared or (J, d) per
    node — evaluate the rate against a learned Gaussian prior on the prior
    kernels, whose backward also yields the prior gradients ("none" ignores
    the prior).

    Dtype contract: u comes back in mu.dtype and the rate in fp32, whatever
    the kernel's internal arithmetic; anything else raises TypeError, so a
    kernel regression cannot silently widen the hot path."""
    u, rate = _bn.cutlayer_fused(mu, logvar, eps, link_bits=link_bits,
                                 rate_estimator=rate_estimator,
                                 prior_mu=prior_mu,
                                 prior_logvar=prior_logvar)
    if u.dtype != mu.dtype:
        raise TypeError(f"cutlayer kernel changed the latent dtype: "
                        f"{mu.dtype} in, {u.dtype} out")
    if rate.dtype != torch.float32:
        raise TypeError(f"cutlayer rate must accumulate in fp32, got "
                        f"{rate.dtype}")
    return u, rate
