"""Dispatching wrappers for the kernels.

Reference: src/repro/kernels/ops.py (`cutlayer`, `attention`,
`ssd_scan`); `attention_bwd`, `grad_norm` and `adamw_` have no
counterpart there (the reference's attention backward and optimizer are
jnp).  The JAX package picks an implementation with
`backend="auto"|"pallas"|"reference"`; here the device
of the tensors decides, and nothing else: a CPU tensor takes the plain
version, a CUDA tensor the hand-written kernel or an exception.  A `meta`
tensor takes the plain version too, which then only propagates shapes
(the dry-run counts a step's FLOPs on meta tensors, launch/dryrun.py).
There is no setting that sends a CUDA tensor to the plain version.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import adamw as _adamw
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
              q_offset: int = 0, return_lse: bool = False, scale=None):
    """Causal (GQA) attention forward.  q: (B, Sq, H, Dh); k, v:
    (B, Sk, KV, Dh); the scores scale q.k, scale None meaning 1/sqrt(Dh).
    CPU and meta tensors take `ref.attention_ref`, CUDA
    tensors the flash kernel (csrc/flash_attn_fwd.cu).  Returns (B, Sq, H,
    Dh) in q's dtype, or with return_lse=True (out, each query row's
    logsumexp (B, Sq, H) fp32), the residual the attention backward
    reads."""
    if q.device.type in _bn.PLAIN:
        return ref.attention_ref(q, k, v, causal=causal, window=window,
                                 q_offset=q_offset, lse=return_lse,
                                 scale=scale)
    return _fa.flash_attn_fwd(q, k, v, causal=causal, window=window,
                              q_offset=q_offset, lse=return_lse, scale=scale)


def attention_bwd(q, k, v, out, lse, dout, *, causal: bool = True,
                  window: int = 0, q_offset: int = 0, block_q: int = 512,
                  block_k: int = 512, scale=None):
    """The attention backward from the forward's saved (q, k, v, out, lse)
    and the output's gradient dout (B, Sq, H, Dh), at the forward's scale
    (None: 1/sqrt(Dh)).  CPU and meta tensors
    take `ref.flash_bwd_ref` (tiles of block_q x block_k), CUDA tensors the
    backward kernel (csrc/flash_attn_bwd.cu, its own tiles).  Returns (dq,
    dk, dv) in q's, k's and v's dtypes."""
    if q.device.type in _bn.PLAIN:
        return ref.flash_bwd_ref(q, k, v, out, lse, dout, causal=causal,
                                 window=window, q_offset=q_offset,
                                 block_q=block_q, block_k=block_k,
                                 scale=scale)
    return _fa.flash_attn_bwd(q, k, v, out, lse, dout, causal=causal,
                              window=window, q_offset=q_offset, scale=scale)


def ssd_scan(x, dt, a, bm, cm, dskip, *, chunk: int):
    """Chunked Mamba2/SSD scan from a zero state.  x: (B, S, H, P); dt:
    (B, S, H) fp32 post-softplus; a, dskip: (H,) fp32; bm, cm: (B, S, N),
    or (B, S, G, N) with G groups dividing H (head h reads group h // (H /
    G)).  CPU and meta tensors take `ref.ssd_chunked_ref`, CUDA tensors the
    scan kernel (csrc/ssd_scan.cu).  Returns (y (B, S, H, P) in x's dtype,
    final state (B, H, N, P) fp32)."""
    if x.device.type in _bn.PLAIN:
        return ref.ssd_chunked_ref(x, dt, a, bm, cm, dskip, chunk=chunk)
    return _ssd.ssd_scan(x, dt, a, bm, cm, dskip, chunk=chunk)


def grad_norm(grads, max_norm):
    """The global norm of a list of gradients and the clip scale min(1,
    max_norm / max(norm, 1e-9)) (1 where max_norm is None or 0), fp32 0-dim
    tensors.  CPU and meta tensors take `ref.grad_norm_ref`, CUDA tensors
    the norm kernel (csrc/adamw.cu): fp64 partial sums in a fixed order,
    no atomics."""
    if grads[0].device.type in _bn.PLAIN:
        return ref.grad_norm_ref(grads, max_norm)
    return _adamw.grad_norm(grads, max_norm)


def adamw_(grads, m, v, master, params, scale, lr, bc1, bc2, *, b1: float,
           b2: float, eps: float, weight_decay: float) -> None:
    """AdamW over lists of leaves, in place: m, v, master (a list, or None:
    the weights are the base) and params, from the gradients times `scale`
    (from `grad_norm`), the learning rate and bias corrections bc1 = 1 -
    b1^t, bc2 = 1 - b2^t (fp32 0-dim tensors).  CPU and meta tensors take
    `ref.adamw_update_ref_`, CUDA tensors the update kernel
    (csrc/adamw.cu), the same operations element by element."""
    if params[0].device.type in _bn.PLAIN:
        return ref.adamw_update_ref_(grads, m, v, master, params, scale, lr,
                                     bc1, bc2, b1=b1, b2=b2, eps=eps,
                                     weight_decay=weight_decay)
    return _adamw.adamw_update(grads, m, v, master, params, scale, lr, bc1,
                               bc2, b1=b1, b2=b2, eps=eps,
                               weight_decay=weight_decay)
