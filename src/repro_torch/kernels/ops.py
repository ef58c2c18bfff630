"""Dispatching wrappers for the kernels.

Reference: src/repro/kernels/ops.py (`cutlayer`, `attention`,
`ssd_scan`).  The JAX package picks an implementation with
`backend="auto"|"pallas"|"reference"`; here the device
of the tensors decides, and nothing else: a CPU tensor takes the plain
version, a CUDA tensor the hand-written kernel or an exception.  There is no
setting that sends a CUDA tensor to the plain version.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import inl_bottleneck as _bn
from repro_torch.kernels import ref
from repro_torch.kernels import ssm_scan as _ssd


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


def attention(q, k, v, *, causal: bool = True, window: int = 0,
              q_offset: int = 0):
    """Causal (GQA) attention forward.  q: (B, Sq, H, Dh); k, v:
    (B, Sk, KV, Dh).  CPU tensors take `ref.attention_ref`, CUDA tensors
    the flash kernel (csrc/flash_attn_fwd.cu).  Returns (B, Sq, H, Dh) in
    q's dtype."""
    if q.device.type == "cpu":
        return ref.attention_ref(q, k, v, causal=causal, window=window,
                                 q_offset=q_offset)
    return _fa.flash_attn_fwd(q, k, v, causal=causal, window=window,
                              q_offset=q_offset)


def ssd_scan(x, dt, a, bm, cm, dskip, *, chunk: int):
    """Chunked Mamba2/SSD scan from a zero state.  x: (B, S, H, P); dt:
    (B, S, H) fp32 post-softplus; a, dskip: (H,) fp32; bm, cm: (B, S, N).
    CPU tensors take `ref.ssd_chunked_ref`, CUDA tensors the scan kernel
    (csrc/ssd_scan.cu).  Returns (y (B, S, H, P) in x's dtype, final state
    (B, H, N, P) fp32)."""
    if x.device.type == "cpu":
        return ref.ssd_chunked_ref(x, dt, a, bm, cm, dskip, chunk=chunk)
    return _ssd.ssd_scan(x, dt, a, bm, cm, dskip, chunk=chunk)
