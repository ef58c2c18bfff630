"""Stochastic bottlenecks for in-network learning.

Reference: src/repro/core/bottleneck.py (`head_init`, `head_apply`,
`sample`, `fused_sample_rate`, `gaussian_logpdf`, `prior_init`,
`prior_logpdf`, `rate_sampled`, `rate_analytic`).  Each edge node j
parametrises P_theta_j(u_j | x_j) as a diagonal Gaussian whose
(mu, log sigma^2) come from the node's network; the prior Q_psi_j(u_j) is a
standard normal by default or a learned diagonal Gaussian.

The rate term of eq. (6), log(P(u|x)/Q(u)), is given both as the paper's
per-sample estimate (at the sampled u) and as the analytic Gaussian KL.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from repro_torch.kernels import ops
from repro_torch.models import layers

LOG2PI = math.log(2.0 * math.pi)


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


def _normal(generator: torch.Generator, like) -> torch.Tensor:
    return torch.randn(like.shape, generator=generator, dtype=torch.float32,
                       device=like.device)


def sample(generator: torch.Generator, mu, logvar):
    """Reparametrised draw u = mu + sigma * eps, computed in fp32 and
    returned in mu.dtype (a bf16 latent stays bf16)."""
    eps = _normal(generator, mu)
    u = mu.to(torch.float32) + torch.exp(0.5 * logvar.to(torch.float32)) \
        * eps
    return u.to(mu.dtype)


def cut_noise(generator: Optional[torch.Generator], mu, eps=None):
    """The cut layer's eps: `eps` as given, else N(0, 1) of mu's shape drawn
    from `generator` on mu's device, else (generator=None) zero, the
    deterministic cut."""
    if eps is None:
        return torch.zeros(mu.shape, dtype=torch.float32, device=mu.device) \
            if generator is None else _normal(generator, mu)
    if generator is not None:
        raise ValueError("pass either generator or eps, not both")
    return eps


def fused_sample_rate(generator: Optional[torch.Generator], mu, logvar, *,
                      link_bits: int = 32, rate_estimator: str = "sample",
                      prior: dict = None, eps=None):
    """The cut-layer hot path in ONE fused kernel pass:

        u    = quantize(mu + exp(logvar/2) * eps)   (..., d)
        rate = eq.-(6) rate term per row             (...,)  fp32

    Leading axes, the J client axis included, fold into the kernel's rows,
    so all nodes share one launch; the backward is the hand-written eq.-(10)
    split.

    eps — the noise, fp32 of mu's shape; or None, and then it is drawn
    N(0, 1) from `generator` on mu's device, or, with generator=None, zero:
    the DETERMINISTIC cut (u == quantize(mu)), the inference path, still
    through the same kernel.  prior — a {"mu", "logvar"} dict of (d,)
    shared or (J, d) per-node learned-prior parameters — switches the rate
    to Q_psi on the prior kernels."""
    eps = cut_noise(generator, mu, eps)
    prior = prior or {}
    return ops.cutlayer(mu, logvar, eps, link_bits=link_bits,
                        rate_estimator=rate_estimator,
                        prior_mu=prior.get("mu"),
                        prior_logvar=prior.get("logvar"))


def gaussian_logpdf(u, mu, logvar):
    lv = logvar.to(torch.float32)
    d = (u - mu).to(torch.float32)
    return -0.5 * torch.sum(lv + LOG2PI + d * d * torch.exp(-lv), dim=-1)


def prior_init(d_bottleneck: int, learned: bool = False,
               num_nodes: int = None, *, device=None):
    """Learned diagonal-Gaussian prior parameters; {} = standard normal.

    num_nodes=J stacks one independent prior per node ((J, d) leaves), the
    shape the prior kernels' per-node rows expect; both start at the
    standard normal (zeros)."""
    if not learned:
        return {}
    shape = (d_bottleneck,) if num_nodes is None \
        else (num_nodes, d_bottleneck)
    return {"mu": torch.zeros(shape, device=device),
            "logvar": torch.zeros(shape, device=device)}


def prior_logpdf(prior, u):
    if prior:
        return gaussian_logpdf(u, prior["mu"], prior["logvar"])
    uf = u.to(torch.float32)
    return -0.5 * torch.sum(uf * uf + LOG2PI, dim=-1)


def rate_sampled(u, mu, logvar, prior=None):
    """The paper's per-sample rate term log(P(u|x) / Q(u)), eq. (6)."""
    return gaussian_logpdf(u, mu, logvar) - prior_logpdf(prior or {}, u)


def rate_analytic(mu, logvar, prior=None):
    """KL( N(mu, sigma^2) || prior ) in closed form."""
    lv = logvar.to(torch.float32)
    muf = mu.to(torch.float32)
    if prior:
        plv = prior["logvar"]
        pmu = prior["mu"]
        return 0.5 * torch.sum(plv - lv + (torch.exp(lv) + (muf - pmu) ** 2)
                               / torch.exp(plv) - 1.0, dim=-1)
    return 0.5 * torch.sum(torch.exp(lv) + muf * muf - 1.0 - lv, dim=-1)
