"""The cut-layer wire format: what the u_j -> fusion-node link carries.

Reference: src/repro/core/wirefmt.py (`resolve_wire`, `shipped_nbytes`).
This slice has the dense wire only: latents move at their storage dtype,
and the bytes one direction moves are the size of that buffer.  The packed
wires ("packed", "packed_duplex") move bit-packed codeword lanes, built by
the pack kernels (`_cut_fwd_pack_kernel`, `_pack_kernel`,
`_unpack_dequant_kernel`), which come with the packed-wire slice.
"""
from __future__ import annotations

import torch

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
