"""Stochastic bottlenecks for in-network learning.

Reference: src/repro/core/bottleneck.py (`head_init`, `head_apply`,
`fused_sample_rate`).  Each edge node j parametrises P_theta_j(u_j | x_j) as
a diagonal Gaussian whose (mu, log sigma^2) come from the node's network;
the prior Q_psi_j(u_j) is a standard normal (learned priors come with their
own slice of the port).
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.kernels import ops
from repro_torch.models import layers


def head_init(generator: torch.Generator, d_in: int, d_bottleneck: int, *,
              device=None):
    """Projection from encoder features to (mu, logvar)."""
    return {"mu": layers.dense_init(generator, d_in, d_bottleneck, bias=True,
                                    device=device),
            "logvar": layers.dense_init(generator, d_in, d_bottleneck,
                                        bias=True, scale=1e-2,
                                        device=device)}


def head_apply(p, h) -> Tuple[torch.Tensor, torch.Tensor]:
    mu = layers.dense(p["mu"], h)
    logvar = torch.clamp(layers.dense(p["logvar"], h), -8.0, 8.0)
    return mu, logvar


def fused_sample_rate(generator: Optional[torch.Generator], mu, logvar, *,
                      link_bits: int = 32, rate_estimator: str = "sample",
                      prior: dict = None):
    """The cut-layer hot path in ONE fused kernel pass:

        u    = quantize(mu + exp(logvar/2) * eps)   (..., d)
        rate = eq.-(6) rate term per row             (...,)  fp32

    Leading axes, the J client axis included, fold into the kernel's rows,
    so all nodes share one launch.

    generator=None runs the DETERMINISTIC cut (eps == 0 -> u ==
    quantize(mu)), the inference path, still through the same kernel; else
    eps ~ N(0, 1) is drawn from `generator` on mu's device."""
    if generator is None:
        eps = torch.zeros(mu.shape, dtype=torch.float32, device=mu.device)
    else:
        eps = torch.randn(mu.shape, generator=generator, dtype=torch.float32,
                          device=mu.device)
    prior = prior or {}
    return ops.cutlayer(mu, logvar, eps, link_bits=link_bits,
                        rate_estimator=rate_estimator,
                        prior_mu=prior.get("mu"),
                        prior_logvar=prior.get("logvar"))
