"""Packed wire format: quantized cut-layer latents travel bit-packed.

Reference: src/repro/core/wirefmt.py (`resolve_wire`, `dyn_quantize`,
`ship`, `relay_hop`, `cut_and_ship`, `shipped_nbytes`,
`round_wire_bytes`).  A quantized latent is a `link_bits`-bit codeword
index, and the packed wires carry those indices in uint32 lanes
(`kernels/inl_bottleneck.pack_values` / `unpack_dequant`, plain versions
in `kernels/ref.py`), 32 / link_bits fewer bytes than fp32.  Packing is a pure re-encoding: unpack(pack(u)) == u
bit for bit on the quantizer's grid, so the packed forward cannot change a
trajectory.

Wire formats (the `wire=` option of `Scheme.make_round` and
`schemes/runner.run_scheme`):

    "dense"          quantized VALUES move at their storage dtype; on one
                     device the wire is the identity.
    "packed"         client -> server latents travel as packed codewords;
                     the server -> client error vectors (eq. 10) stay dense.
                     Trajectories are bit-identical to "dense".
    "packed_duplex"  both directions packed at link_bits: the backward link
                     quantizes each error vector with a per-row dynamic
                     scale (`dyn_quantize`, straight-through).  Measured
                     bytes equal the paper's symmetric 2 b p s closed form;
                     trajectories track the dense path only approximately.

Both packed wires need a packable width, 1 <= link_bits <= 16.

The differentiable units are `torch.autograd.Function`s spanning
pack -> unpack, so no gradient flows through integer codewords:
`cut_and_ship` runs the pack-emitting fused kernel (the lanes are a free
third output of the one forward pass) and hands the cotangent sum to the
fused eq.-(10) backward the dense path uses; `ship` packs an existing
quantized latent (the learned-prior and split-learning paths).  On one
device the pack -> unpack round trip simulates the link: the same values
and the same measured bytes as a real transfer.  `relay_hop` is one edge of
a multi-hop topology (core/topology.graph_cut_and_ship): it re-quantizes
the payload it forwards at its edge's width and ships it over that edge's
wire.

On a mesh (core/sharded.py) `axis_name=` is the 'client' Axis
(launch/mesh.Mesh.axis) and the wire is the fusion node's fan-in, one
collective over it: "dense" all-gathers the quantized values, "packed"
all-gathers the uint32 codeword lanes (as int32: the collectives have no
uint32).  Backward, every wire sums the ranks' dense cotangents with a
reduce-scatter and hands each node its own error chunk; "packed_duplex"
quantizes that chunk after the reduce-scatter, as the reference does (the
meter charges the quantized chunk, not the dense reduce-scatter that
executes).  The keyword keeps the reference's name; a string there raises
TypeError.

Measured bytes come from the sizes of the real buffers: the lanes of the
plain pack on a meta tensor (shape and dtype, no allocation), and the dense
buffer at its storage dtype.  The duplex backward's per-row fp32 scales
ride the control channel and are not counted, as packet headers are not in
the paper's accounting.
"""
from __future__ import annotations

import torch

from repro_torch.core import bottleneck
from repro_torch.kernels import inl_bottleneck as _bn
from repro_torch.kernels import ref

WIRE_FORMATS = ("dense", "packed", "packed_duplex")


def resolve_wire(wire: str, link_bits: int):
    """Validate the wire format against the link width.  Returns (wire,
    bwd_bits): bwd_bits is the backward link's code width (None: dense
    error vectors)."""
    if wire not in WIRE_FORMATS:
        raise ValueError(f"unknown wire format {wire!r}; "
                         f"known: {WIRE_FORMATS}")
    if wire != "dense" and not 1 <= link_bits <= 16:
        raise ValueError(f"wire={wire!r} needs a packable link width "
                         f"(1 <= link_bits <= 16), got link_bits="
                         f"{link_bits}; use wire='dense' for full-precision "
                         "links")
    return wire, (link_bits if wire == "packed_duplex" else None)


def check_axis(axis_name):
    """`axis_name` as given: None (one device) or a mesh Axis; the
    reference's axis NAME is refused, since a collective here needs the
    axis' process group."""
    if isinstance(axis_name, str):
        raise TypeError(f"axis_name= takes a mesh Axis "
                        f"(launch.mesh.Mesh.axis({axis_name!r})), not the "
                        f"axis name {axis_name!r}")
    return axis_name


def dyn_quantize(g, bits: int, axis=-1):
    """Dynamic-scale uniform quantizer (value map) of the backward link:
    the error vectors g (..., d) are coded on a (2^bits - 1)-level grid
    over [-max|g|, max|g|], the maximum taken over `axis`: by default each
    row's, which makes the result independent of batch or client
    sharding; axis=None gives the per-tensor scale of
    `linkmodel.packed_wire_concat`."""
    gf = g.to(torch.float32)
    m = torch.amax(torch.abs(gf)) if axis is None \
        else torch.amax(torch.abs(gf), dim=axis, keepdim=True)
    # a tensor divided by a tensor: torch computes float / tensor as a
    # reciprocal times the float, which is not the reference's division;
    # the 0-dim numerator is a fill on the device (no host copy, so a
    # captured round can run it)
    levels = torch.full((), float((1 << bits) - 1), dtype=torch.float32,
                        device=g.device)
    scale = levels / (2.0 * torch.clamp_min(m, 1e-12))
    q = torch.round((torch.clamp(gf, -m, m) + m) * scale) / scale - m
    return q.to(g.dtype)


# ---------------------------------------------------------------------------
# ship: an existing quantized latent crosses the wire packed
# ---------------------------------------------------------------------------

class _Ship(torch.autograd.Function):
    """pack -> (gather the lanes over `axis`) -> unpack on the forward; the
    backward hands each node its error chunk straight through (on a mesh
    the reduce-scatter of the dense cotangent; packed_duplex: then
    quantized at bwd_bits)."""

    @staticmethod
    def forward(ctx, u, bits, bwd_bits, axis):
        ctx.bwd_bits, ctx.axis = bwd_bits, axis
        lanes = _bn.pack_values(u, link_bits=bits)
        if axis is not None:
            lanes = axis.gather(lanes)
        return _bn.unpack_dequant(lanes, u.shape[-1], link_bits=bits,
                                  dtype=u.dtype)

    @staticmethod
    def backward(ctx, g):
        if ctx.axis is not None:
            g = ctx.axis.reduce_scatter(g)
        if ctx.bwd_bits is not None:
            g = dyn_quantize(g, ctx.bwd_bits)
        return g, None, None, None


def ship(u, *, link_bits: int, wire: str = "dense", axis_name=None):
    """Move a quantized latent u (..., d) across the client -> server wire.

    dense: the identity on one device, the tiled all_gather over the
    'client' Axis `axis_name` on a mesh.  packed: the buffer on the wire is
    uint32 codeword lanes (gathered over the axis); the values arrive
    unchanged.  The backward returns each node its eq.-(10) error chunk
    (straight through; packed_duplex also quantizes it at link_bits)."""
    wire, bwd_bits = resolve_wire(wire, link_bits)
    axis = check_axis(axis_name)
    if wire == "dense":
        return u if axis is None else axis.all_gather(u)
    return _Ship.apply(u, link_bits, bwd_bits, axis)


def relay_hop(x, *, link_bits: int, wire: str = "dense", dtype=None):
    """One edge traversal of a multi-hop topology (core/topology.py): a
    relay re-encodes the payload x (..., d) it forwards for ITS outgoing
    link.

    Forward: straight-through re-quantization of the (already quantized)
    values at this edge's `link_bits` (`ref.quantize_value`, plain torch as
    in the reference) — the identity when the payload is already on this
    grid, a genuine re-coding when an upstream link was finer — then, for a
    dense edge narrower than x's dtype, a straight-through round trip
    through the edge's storage `dtype`, and finally the edge's wire
    (`ship`: on a packed edge the pack and unpack kernels, a lossless
    re-encoding; "packed_duplex" also quantizes the BACKWARD error chunk at
    `link_bits` on every traversal, so a b-hop route's eq.-(10) error vector
    is b-times link-quantized)."""
    wire, _ = resolve_wire(wire, link_bits)
    q = ref.quantize_value(x.to(torch.float32), link_bits).to(x.dtype)
    x = x + (q - x).detach()
    if wire == "dense" and dtype is not None and dtype != x.dtype:
        rt = x.to(dtype).to(x.dtype)
        x = x + (rt - x).detach()
    return ship(x, link_bits=link_bits, wire=wire)


# ---------------------------------------------------------------------------
# cut_and_ship: the fused cut layer with the wire folded into the kernel
# ---------------------------------------------------------------------------

class _CutShip(torch.autograd.Function):
    """(mu, logvar, eps) -> (u, rate, u_shipped) through the pack-emitting
    kernel, (on a mesh) the gather of the lanes over `axis`, and the
    unpack; the backward is the fused eq.-(10) split on the sum of the
    node's own cotangent gu and its error chunk from the fusion node (on a
    mesh the reduce-scatter of the dense cotangent; packed_duplex: that
    chunk quantized at bwd_bits)."""

    @staticmethod
    def forward(ctx, mu, logvar, eps, bits, mode, bwd_bits, axis):
        ctx.bits, ctx.mode, ctx.bwd_bits, ctx.axis = bits, mode, bwd_bits, \
            axis
        ctx.save_for_backward(mu, logvar, eps)
        u, lanes, rate = _bn.cutlayer_pack_forward(
            mu, logvar, eps, link_bits=bits, rate_estimator=mode)
        if axis is not None:
            lanes = axis.gather(lanes)
        u_shipped = _bn.unpack_dequant(lanes, mu.shape[-1], link_bits=bits,
                                       dtype=u.dtype)
        return u, rate, u_shipped

    @staticmethod
    def backward(ctx, gu, grate, g_shipped):
        mu, logvar, eps = ctx.saved_tensors
        if ctx.axis is not None:
            g_shipped = ctx.axis.reduce_scatter(g_shipped)
        if ctx.bwd_bits is not None:
            g_shipped = dyn_quantize(g_shipped, ctx.bwd_bits)
        grads = _bn.cutlayer_backward(mu, logvar, eps,
                                      gu + g_shipped.to(gu.dtype), grate,
                                      link_bits=ctx.bits,
                                      rate_estimator=ctx.mode)
        return (*grads, None, None, None, None)


def cut_and_ship(generator, mu, logvar, *, link_bits: int,
                 rate_estimator: str = "sample", wire: str = "dense",
                 axis_name=None, prior: dict = None, eps=None):
    """The cut-layer transaction: sample + quantize + rate + wire.

    Returns (u, rate, u_shipped): u (..., d) the node-local quantized latent
    (the branch heads read it), rate (...,) the eq.-(6) term and u_shipped
    what the fusion node receives, equal in value (on a mesh, every node's
    rows gathered over the 'client' Axis `axis_name`).  wire="dense" runs
    `bottleneck.fused_sample_rate` and hands the fusion node the same
    tensor, so autograd sums the branch heads' and the decoder's cotangents
    into one gu; "packed"/"packed_duplex" run the pack-emitting kernel and
    the unpack, and the backward adds the two cotangents itself before the
    same fused backward — the packed trajectory equals the dense one bit
    for bit.  A learned `prior` keeps its own kernel pair and Function, so
    its wire is the standalone `ship`.

    The noise: `eps` (..., d) fp32, else drawn from `generator`;
    generator=None and eps=None is the deterministic cut (eps == 0)."""
    wire, bwd_bits = resolve_wire(wire, link_bits)
    axis = check_axis(axis_name)
    if wire == "dense" or prior:
        u, rate = bottleneck.fused_sample_rate(
            generator, mu, logvar, link_bits=link_bits,
            rate_estimator=rate_estimator, prior=prior, eps=eps)
        return u, rate, ship(u, link_bits=link_bits, wire=wire,
                             axis_name=axis)
    eps = bottleneck.cut_noise(generator, mu, eps)
    return _CutShip.apply(mu, logvar, eps.to(torch.float32), link_bits,
                          rate_estimator, bwd_bits, axis)


# ---------------------------------------------------------------------------
# Measured bytes: what the wire buffers occupy
# ---------------------------------------------------------------------------

def shipped_nbytes(n_vectors: int, d: int, *, link_bits: int,
                   wire: str = "dense", dtype=torch.float32) -> int:
    """Bytes ONE direction of the wire moves for `n_vectors` d-vectors: the
    size of the buffer the wire's op makes, taken from a meta tensor (shape
    and dtype without an allocation) — the lanes of the pack for packed
    wires (independent of the value dtype), the dense buffer at its storage
    dtype otherwise."""
    wire, _ = resolve_wire(wire, link_bits)
    if wire == "dense":
        return torch.empty((n_vectors, d), dtype=dtype, device="meta").nbytes
    values = torch.empty((n_vectors, d), dtype=torch.float32, device="meta")
    return ref.pack_values_ref(values, link_bits).nbytes


def round_wire_bytes(n_vectors: int, d: int, *, link_bits: int,
                     wire: str = "dense", dtype=torch.float32) -> dict:
    """Measured bytes of one training round's cut-layer exchange:
    activations forward + error vectors backward (§III-C's two directions).

    dense: both directions at the storage dtype.  packed: forward codeword
    lanes, backward dense.  packed_duplex: both directions as codeword
    lanes."""
    wire, bwd_bits = resolve_wire(wire, link_bits)
    fwd = shipped_nbytes(n_vectors, d, link_bits=link_bits, wire=wire,
                         dtype=dtype)
    if bwd_bits is not None:
        bwd = shipped_nbytes(n_vectors, d, link_bits=bwd_bits,
                             wire="packed", dtype=dtype)
    else:
        bwd = shipped_nbytes(n_vectors, d, link_bits=link_bits, wire="dense",
                             dtype=dtype)
    return {"fwd": fwd, "bwd": bwd, "total": fwd + bwd}
