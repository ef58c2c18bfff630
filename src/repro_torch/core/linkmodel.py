"""Finite-capacity links: the uniform link quantizer and the bit counts.

Reference: src/repro/core/linkmodel.py (`quantize_st`, `activation_bits`,
`training_step_bits`, `inference_step_bits`).  Each edge node j talks to
node (J+1) over an error-free link of capacity C_j (§II, eq. 1); the
capacity is simulated by a uniform scalar quantizer over the bottleneck
activations, with straight-through gradients, and the bits are counted
exactly.  The int8 and packed GSPMD wires of the reference's LLM stack
(`wire_concat`, `packed_wire_concat`) come with the LLM slice of the port.
"""
from __future__ import annotations

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


def activation_bits(batch: int, width: int, bits: int) -> int:
    """Bits to move `width` activation values per sample across a link."""
    return batch * width * bits


def training_step_bits(batch: int, p_total: int, bits: int) -> int:
    """Paper §III-C: forward activations + backward error vectors = 2 b p s."""
    return 2 * batch * p_total * bits


def inference_step_bits(batch: int, p_total: int, bits: int) -> int:
    """Inference sends the forward activations only."""
    return batch * p_total * bits
