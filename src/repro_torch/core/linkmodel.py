"""Finite-capacity links: the uniform link quantizer and the bit counts.

Reference: src/repro/core/linkmodel.py (`quantize_st`, `transmit`,
`_to_int8`, `_from_int8`, `wire_concat`, `float_concat`,
`packed_wire_concat`, `activation_bits`, `training_step_bits`,
`inference_step_bits`).  Each edge node j talks to node (J+1) over an
error-free link of capacity C_j (§II, eq. 1); the capacity is simulated
by a uniform scalar quantizer over the bottleneck activations, with
straight-through gradients, and the bits are counted exactly.

INL over an LLM (core/inl_llm.py) crosses the eq.-(5) boundary on a
compressed wire: int8 (`wire_concat`) or bit-packed codewords
(`packed_wire_concat`, the `pack` and `unpack_dequant` kernels on the
card), each with a backward link quantized on a dynamic scale.  The
reference pins their gathers with partition specs, which are None
without a 'client' mesh axis; the port's wires have none (one device).
Both packages round half to even (`jnp.round`, `torch.round`).
"""
from __future__ import annotations

import torch

from repro_torch.kernels import inl_bottleneck as _bn
from repro_torch.kernels import ref as _kref

QUANT_RANGE = _kref.QUANT_RANGE       # one source of truth with the kernels


def quantize_st(u, bits: int, *, u_range: float = QUANT_RANGE):
    """Uniform quantizer with a straight-through gradient.

    bits >= 32 is the identity (a full-precision link).  The value map is
    kernels/ref.quantize_value, the arithmetic the cut-layer kernels bake
    in; the gradient passes through as if the quantizer were the
    identity."""
    if bits >= 32:
        return u
    q = _kref.quantize_value(u, bits, u_range=u_range)
    return u + (q - u).detach()


def transmit(generator, mu, logvar, *, bits: int,
             rate_estimator: str = "sample", eps=None):
    """The fused node -> (J+1) transmission, everything the edge sends in
    one pass: eps (given, or drawn from `generator`), then ONE cut-layer
    launch gives the quantized latent u and the per-row rate of eq. (6);
    the backward is the eq.-(10) split.  mu/logvar: (..., d), every
    leading axis (J clients, batch) folded into the kernel's rows.
    Returns (u, rate)."""
    from repro_torch.core import bottleneck
    return bottleneck.fused_sample_rate(generator, mu, logvar,
                                        link_bits=bits,
                                        rate_estimator=rate_estimator,
                                        eps=eps)


_WIRE_RANGE = 4.0                 # Gaussian bottlenecks: 4 sigma coverage
_WIRE_SCALE = _WIRE_RANGE / 127.0


def _to_int8(u):
    return torch.clamp(torch.round(u.to(torch.float32) / _WIRE_SCALE),
                       -127, 127).to(torch.int8)


def _from_int8(q, dtype):
    return (q.to(torch.float32) * _WIRE_SCALE).to(dtype)


def _merge_nodes(t):
    """(J, B, S, d) -> (B, S, J d): node j's columns at j d."""
    J, B, S, d = t.shape
    return t.permute(1, 2, 0, 3).reshape(B, S, J * d)


def _split_nodes(g, J: int):
    """(B, S, J d) -> (J, B, S, d), the inverse of `_merge_nodes`."""
    B, S, jd = g.shape
    return g.reshape(B, S, J, jd // J).permute(2, 0, 1, 3)


class _WireConcat(torch.autograd.Function):
    @staticmethod
    def forward(ctx, u):
        ctx.J, ctx.dtype = u.shape[0], u.dtype
        return _from_int8(_merge_nodes(_to_int8(u)), u.dtype)

    @staticmethod
    def backward(ctx, g):
        gf = g.to(torch.float32)
        scale = torch.clamp_min(torch.amax(torch.abs(gf)), 1e-12) / 127.0
        g8 = torch.clamp(torch.round(gf / scale), -127, 127).to(torch.int8)
        du8 = _split_nodes(g8, ctx.J)                  # the backward link
        return (du8.to(torch.float32) * scale).to(ctx.dtype)


def wire_concat(u):
    """The INL node -> (J+1) boundary as an int8 wire.  u: (J, B, S, d_b)
    -> (B, S, J d_b) in u's dtype: each node's latents quantized to int8
    on the fixed ±4 range, concatenated, dequantized.  The backward is the
    eq.-(8c) error-vector split, straight through the quantizer, the
    cotangent itself int8-quantized on a dynamic per-tensor scale (the
    backward link)."""
    return _WireConcat.apply(u)


def float_concat(u):
    """The uncompressed boundary (link_bits >= 16): the eq.-(5) concat,
    (J, B, S, d_b) -> (B, S, J d_b)."""
    return _merge_nodes(u)


class _PackedWireConcat(torch.autograd.Function):
    @staticmethod
    def forward(ctx, u, bits):
        ctx.J, ctx.dtype, ctx.bits = u.shape[0], u.dtype, bits
        packed = _bn.pack_values(u, link_bits=bits)       # (J, B, S, W)
        vals = _bn.unpack_dequant(packed, u.shape[-1], link_bits=bits,
                                  dtype=u.dtype)
        return _merge_nodes(vals)

    @staticmethod
    def backward(ctx, g):
        from repro_torch.core import wirefmt
        gq = wirefmt.dyn_quantize(g.to(torch.float32), ctx.bits, axis=None)
        return _split_nodes(gq, ctx.J).to(ctx.dtype), None


def packed_wire_concat(u, bits: int):
    """The INL node -> (J+1) boundary as a sub-byte packed wire (link_bits
    < 8).  u: (J, B, S, d_b) -> (B, S, J d_b) in u's dtype: the latents
    quantized onto the shared `bits`-level grid and moved as bit-packed
    uint32 codeword lanes (`pack_values`, 32 // bits values a lane), then
    unpacked and dequantized (`unpack_dequant`).  The backward is the
    eq.-(8c) split with the cotangent quantized at the same `bits` on a
    dynamic per-tensor scale (`wirefmt.dyn_quantize(axis=None)`)."""
    return _PackedWireConcat.apply(u, bits)


def activation_bits(batch: int, width: int, bits: int) -> int:
    """Bits to move `width` activation values per sample across a link."""
    return batch * width * bits


def training_step_bits(batch: int, p_total: int, bits: int) -> int:
    """Paper §III-C: forward activations + backward error vectors = 2 b p s."""
    return 2 * batch * p_total * bits


def inference_step_bits(batch: int, p_total: int, bits: int) -> int:
    """Inference sends the forward activations only."""
    return batch * p_total * bits
