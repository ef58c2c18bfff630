"""The cut-layer wire format: what the u_j -> fusion-node link carries.

Reference: src/repro/core/wirefmt.py (`resolve_wire`, `cut_and_ship`,
`shipped_nbytes`, `round_wire_bytes`).  The port has the dense wire only:
latents move at their storage dtype, and the bytes one direction moves are
the size of that buffer.  On one device the dense wire's `ship` is the
identity, so what the fusion node receives IS the edge's u.  The packed
wires ("packed", "packed_duplex") move bit-packed codeword lanes, built by
the pack kernels (`_cut_fwd_pack_kernel`, `_pack_kernel`,
`_unpack_dequant_kernel`), which come with the packed-wire slice.
"""
from __future__ import annotations

import torch

from repro_torch.core import bottleneck

WIRE_FORMATS = ("dense", "packed", "packed_duplex")


def resolve_wire(wire: str, link_bits: int) -> str:
    """Validate the wire format; raise for those not ported yet."""
    if wire not in WIRE_FORMATS:
        raise ValueError(f"unknown wire format {wire!r}; "
                         f"known: {WIRE_FORMATS}")
    if wire != "dense":
        raise NotImplementedError(
            f"wire={wire!r} moves bit-packed codewords through the pack "
            "kernels, which come with the packed-wire slice of the port; "
            "this slice ships wire='dense'")
    return wire


def shipped_nbytes(n_vectors: int, d: int, *, link_bits: int,
                   wire: str = "dense", dtype=torch.float32) -> int:
    """Bytes ONE direction of the wire moves for `n_vectors` d-vectors: the
    size of the dense buffer at its storage dtype (a meta tensor — shape and
    dtype without an allocation)."""
    resolve_wire(wire, link_bits)
    return torch.empty((n_vectors, d), dtype=dtype, device="meta").nbytes


def cut_and_ship(generator, mu, logvar, *, link_bits: int,
                 rate_estimator: str = "sample", wire: str = "dense",
                 prior: dict = None, eps=None):
    """The cut-layer transaction: sample + quantize + rate + wire.

    Returns (u, rate, u_shipped): u (..., d) the node-local quantized latent
    (the branch heads read it), rate (...,) the eq.-(6) term and u_shipped
    what the fusion node receives — on the dense wire on one device the
    same tensor, so autograd sums the branch heads' and the decoder's
    cotangents into one gu, as the reference's identity `ship` does.
    generator/eps/prior as in bottleneck.fused_sample_rate."""
    resolve_wire(wire, link_bits)
    u, rate = bottleneck.fused_sample_rate(
        generator, mu, logvar, link_bits=link_bits,
        rate_estimator=rate_estimator, prior=prior, eps=eps)
    return u, rate, u


def round_wire_bytes(n_vectors: int, d: int, *, link_bits: int,
                     wire: str = "dense", dtype=torch.float32) -> dict:
    """Measured bytes of one training round's cut-layer exchange:
    activations forward + error vectors backward (§III-C's two directions),
    each at the size of its dense buffer."""
    fwd = shipped_nbytes(n_vectors, d, link_bits=link_bits, wire=wire,
                         dtype=dtype)
    bwd = shipped_nbytes(n_vectors, d, link_bits=link_bits, wire=wire,
                         dtype=dtype)
    return {"fwd": fwd, "bwd": bwd, "total": fwd + bwd}
