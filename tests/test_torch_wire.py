"""The port's packed wire (repro_torch/kernels pack entries and
repro_torch/core/wirefmt) against the JAX reference.

Inputs are seeded numpy arrays handed to both packages.  Bars:
  * codeword lanes and codewords: identical bit for bit (lanes compared as
    numpy uint32 arrays) against `impl="reference"`, and in one small case
    against the Pallas kernels in interpret mode.  In the pack-emitting
    forward a codeword whose pre-quantization value lies within 1e-6 of a
    rounding midpoint may differ (XLA's and PyTorch's CPU expf differ in the
    last ulp); such rows are counted and left out, as in
    tests/test_torch_cutlayer.py.
  * dequantized values: within one ulp of the working type (XLA's CPU jit
    computes idx / scale - r as an FMA with the reciprocal; the port
    divides).  Within the port, unpack(pack(u)) == u bit for bit and the
    pack-emitting forward's (u, rate) equal `cutlayer_fused`'s bit for bit.
  * the rate: rtol 1e-5, atol 1e-5.
  * `dyn_quantize`: codewords identical, values within one ulp.
  * `resolve_wire`, `shipped_nbytes`, `round_wire_bytes`: equal to JAX's
    for every wire and b in {1, 2, 3, 4, 8, 16}.
  * `ship` and `cut_and_ship`: "packed" equals "dense" bit for bit, values
    and gradients; the "packed_duplex" backward equals the reference's
    custom VJP within rtol 1e-5, atol 1e-6.

The CUDA kernels run only on the card: their test takes the `cuda_device`
fixture, which skips here with a reason.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import wirefmt as jwire  # noqa: E402
from repro.kernels import inl_bottleneck as jbn  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro_torch.core import wirefmt  # noqa: E402
from repro_torch.kernels import inl_bottleneck as tbn  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from _torch_common import cuda_device  # noqa: E402,F401 (fixture)
from _torch_common import cut_inputs, near_midpoint  # noqa: E402

PACK_BITS = (1, 2, 3, 4, 8, 16)
WIDTHS = (7, 16, 64)
MODES = ("sample", "analytic", "none")
T = torch.from_numpy


def _quantized(shape, bits, seed):
    """Values on the b-bit grid (clipping included), from the port's
    quantizer, as fp32 numpy."""
    x = np.random.default_rng(seed).normal(scale=2.5, size=shape)
    return ref.quantize_value(T(x.astype(np.float32)), bits).numpy()


def _ulp_close(a, b, dtype=np.float32):
    ulp = 2.0 ** -6 if dtype == "bf16" else 5e-7         # at |u| <= 4
    np.testing.assert_allclose(np.asarray(a, np.float32),
                               np.asarray(b, np.float32), rtol=0, atol=ulp)


def test_lane_geometry_matches_jax():
    for bits in range(1, 17):
        assert ref.vals_per_word(bits) == jref.vals_per_word(bits)
        for d in (1, 7, 13, 16, 64, 96):
            assert ref.packed_width(d, bits) == jref.packed_width(d, bits)
    assert ref.packed_width(64, 3) == 7                   # 10 a lane
    for bits in (0, 17, 32):
        with pytest.raises(ValueError, match="packable"):
            ref.vals_per_word(bits)


@pytest.mark.parametrize("d", WIDTHS)
@pytest.mark.parametrize("bits", PACK_BITS)
def test_plain_pack_and_unpack_match_jax(bits, d):
    u = _quantized((5, 9, d), bits, seed=bits * 100 + d)
    lanes = tbn.pack_values(T(u), link_bits=bits)
    assert lanes.dtype == torch.uint32
    assert lanes.shape == (5, 9, ref.packed_width(d, bits))
    want = np.asarray(jref.pack_values_ref(jnp.asarray(u), bits))
    assert want.dtype == np.uint32
    np.testing.assert_array_equal(lanes.numpy(), want)
    # codewords both ways, and the tail of the last lane zero
    idx = ref.quantize_index(T(u), bits)
    np.testing.assert_array_equal(
        idx.numpy(), np.asarray(jref.quantize_index(jnp.asarray(u), bits)))
    np.testing.assert_array_equal(
        ref.unpack_indices(lanes, d, bits).numpy(),
        np.asarray(jref.unpack_indices(jnp.asarray(want), d, bits)))
    vpw = ref.vals_per_word(bits)
    used = (d - (ref.packed_width(d, bits) - 1) * vpw) * bits
    if used < 32:
        assert not (lanes.numpy()[..., -1] >> np.uint32(used)).any()
    # the port's round trip is the identity; JAX's dequantize within 1 ulp
    back = tbn.unpack_dequant(lanes, d, link_bits=bits)
    assert back.dtype == torch.float32 and torch.equal(back, T(u))
    _ulp_close(back.numpy(), jref.unpack_dequant_ref(jnp.asarray(want), d,
                                                     bits))
    if bits <= 8:
        bf = tbn.unpack_dequant(lanes, d, link_bits=bits,
                                dtype=torch.bfloat16)
        assert bf.dtype == torch.bfloat16
        assert torch.equal(tbn.pack_values(bf, link_bits=bits), lanes)


@pytest.mark.parametrize("dt", ["fp32", "bf16"])
@pytest.mark.parametrize("bits", [1, 3, 8, 16])
@pytest.mark.parametrize("mode", MODES)
def test_pack_forward_matches_jax_and_the_dense_kernel(mode, bits, dt):
    shape = (5, 7, 16)
    mu, lv, eps = cut_inputs(shape, seed=bits + 40)
    tdt = {"fp32": torch.float32, "bf16": torch.bfloat16}[dt]
    tmu, tlv = T(mu).to(tdt), T(lv).to(tdt)
    u, lanes, rate = tbn.cutlayer_pack_forward(tmu, tlv, T(eps),
                                               link_bits=bits,
                                               rate_estimator=mode)
    assert u.dtype == tdt and lanes.dtype == torch.uint32
    assert lanes.shape == shape[:-1] + (ref.packed_width(16, bits),)
    # (u, rate) of the pack-emitting forward == the dense cut, bit for bit
    u2, rate2 = ops.cutlayer(tmu, tlv, T(eps), link_bits=bits,
                             rate_estimator=mode)
    assert torch.equal(u, u2) and torch.equal(rate, rate2)
    assert torch.equal(tbn.unpack_dequant(lanes, 16, link_bits=bits,
                                          dtype=tdt), u)
    jdt = {"fp32": jnp.float32, "bf16": jnp.bfloat16}[dt]
    ju, jlanes, jrate = jbn.cutlayer_pack_forward(
        jnp.asarray(tmu.float().numpy(), jdt),
        jnp.asarray(tlv.float().numpy(), jdt), jnp.asarray(eps),
        link_bits=bits, rate_estimator=mode, impl="reference")
    mid = near_midpoint(tmu.float().numpy(), tlv.float().numpy(), eps,
                        bits).any(-1)
    ok = ~mid
    np.testing.assert_array_equal(lanes.numpy()[ok], np.asarray(jlanes)[ok])
    _ulp_close(u.float().numpy()[ok], np.asarray(ju, np.float32)[ok],
               dt if dt == "bf16" else np.float32)
    np.testing.assert_allclose(rate.numpy()[ok], np.asarray(jrate)[ok],
                               rtol=1e-5, atol=1e-5)
    print(f"{mode} b={bits} {dt}: {int(mid.sum())} midpoint rows")


def test_pallas_pack_kernels_in_interpret_mode_match_the_port():
    """The reference's three Pallas kernels, run in interpret mode, on a
    ragged (97, 16) block at b = 3 (10 codewords and 2 padding bits a
    lane)."""
    bits, d = 3, 16
    mu, lv, eps = cut_inputs((97, d), seed=5)
    u, lanes, rate = tbn.cutlayer_pack_forward(T(mu), T(lv), T(eps),
                                               link_bits=bits)
    kw = dict(impl="pallas", interpret=True, block_t=64)
    ju, jlanes, jrate = jbn.cutlayer_pack_forward(
        jnp.asarray(mu), jnp.asarray(lv), jnp.asarray(eps), link_bits=bits,
        rate_estimator="sample", **kw)
    ok = ~near_midpoint(mu, lv, eps, bits).any(-1)
    np.testing.assert_array_equal(lanes.numpy()[ok], np.asarray(jlanes)[ok])
    _ulp_close(u.numpy()[ok], np.asarray(ju)[ok])
    np.testing.assert_allclose(rate.numpy()[ok], np.asarray(jrate)[ok],
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(
        np.asarray(jbn.pack_values(jnp.asarray(u.numpy()), link_bits=bits,
                                   **kw)), lanes.numpy())
    _ulp_close(np.asarray(jbn.unpack_dequant(jnp.asarray(lanes.numpy()), d,
                                             link_bits=bits, **kw)),
               u.numpy())


def test_pack_entries_refuse_what_the_reference_refuses():
    u = T(_quantized((4, 16), 8, seed=1))
    for bits in (9, 12, 16):
        with pytest.raises(ValueError, match="half-precision mantissa"):
            tbn.pack_values(u.to(torch.bfloat16), link_bits=bits)
        with pytest.raises(ValueError, match="half-precision mantissa"):
            jbn.pack_values(jnp.asarray(u.numpy(), jnp.bfloat16),
                            link_bits=bits, impl="reference")
    assert tbn.pack_values(u.to(torch.bfloat16), link_bits=8).shape == (4, 4)
    for bits in (0, 17, 32):
        with pytest.raises(ValueError, match="packable"):
            tbn.pack_values(u, link_bits=bits)
        with pytest.raises(ValueError, match="packable"):
            tbn.cutlayer_pack_forward(u, u, u, link_bits=bits)
    lanes = tbn.pack_values(u, link_bits=4)
    with pytest.raises(ValueError, match="does not match"):
        tbn.unpack_dequant(lanes, 17, link_bits=4)
    with pytest.raises(ValueError, match="does not match"):
        jbn.unpack_dequant(jnp.asarray(lanes.numpy()), 17, link_bits=4,
                           impl="reference")
    with pytest.raises(ValueError, match="unknown rate_estimator"):
        tbn.cutlayer_pack_forward(u, u, u, link_bits=4,
                                  rate_estimator="exact")


def test_cpu_tensors_take_the_plain_versions_and_kernels_refuse_them():
    before = dict(tbn.LAUNCHES)
    mu, lv, eps = (T(x) for x in cut_inputs((6, 16), seed=2))
    u, lanes, _ = tbn.cutlayer_pack_forward(mu, lv, eps, link_bits=4)
    tbn.unpack_dequant(tbn.pack_values(u, link_bits=4), 16, link_bits=4)
    assert tbn.LAUNCHES == before
    for launch in (lambda: tbn.cut_fwd_pack(mu, lv, eps, bits=4,
                                            mode="sample"),
                   lambda: tbn.pack(u, bits=4),
                   lambda: tbn.unpack(lanes, d=16, bits=4)):
        with pytest.raises(ValueError, match="CUDA tensors"):
            launch()
    assert {"cut_fwd_pack", "pack", "unpack_dequant"} <= set(tbn.LAUNCHES)


def test_resolve_wire_matches_jax():
    for wire in wirefmt.WIRE_FORMATS:
        for bits in (1, 2, 3, 4, 8, 16, 32):
            if wire != "dense" and bits == 32:
                for resolve in (wirefmt.resolve_wire, jwire.resolve_wire):
                    with pytest.raises(ValueError, match="packable"):
                        resolve(wire, bits)
                continue
            assert wirefmt.resolve_wire(wire, bits) == \
                jwire.resolve_wire(wire, bits)
    assert wirefmt.resolve_wire("packed_duplex", 4) == ("packed_duplex", 4)
    for resolve in (wirefmt.resolve_wire, jwire.resolve_wire):
        with pytest.raises(ValueError, match="unknown wire"):
            resolve("zip", 8)
        with pytest.raises(ValueError, match="packable"):
            resolve("packed", 0)


@pytest.mark.parametrize("wire", ["dense", "packed", "packed_duplex"])
def test_measured_bytes_match_jax(wire):
    for bits in PACK_BITS:
        for n in (1, 20, 320):
            for d in WIDTHS:
                for tdt, jdt in ((torch.float32, jnp.float32),
                                 (torch.bfloat16, jnp.bfloat16)):
                    assert wirefmt.shipped_nbytes(
                        n, d, link_bits=bits, wire=wire, dtype=tdt) == \
                        jwire.shipped_nbytes(n, d, link_bits=bits,
                                             wire=wire, dtype=jdt)
                    assert wirefmt.round_wire_bytes(
                        n, d, link_bits=bits, wire=wire, dtype=tdt) == \
                        jwire.round_wire_bytes(n, d, link_bits=bits,
                                               wire=wire, dtype=jdt)
    # the size is the real buffer's
    u = T(_quantized((10, 13), 4, seed=3))
    if wire != "dense":
        assert wirefmt.shipped_nbytes(10, 13, link_bits=4, wire=wire) == \
            tbn.pack_values(u, link_bits=4).nbytes
    # the training step's numbers at the paper's width: 320 vectors of 64
    rb = wirefmt.round_wire_bytes(320, 64, link_bits=8, wire=wire)
    want = {"dense": (320 * 64 * 4, 320 * 64 * 4),
            "packed": (320 * 16 * 4, 320 * 64 * 4),
            "packed_duplex": (320 * 16 * 4, 320 * 16 * 4)}[wire]
    assert (rb["fwd"], rb["bwd"]) == want


@pytest.mark.parametrize("bits", [2, 4, 8, 16])
def test_dyn_quantize_matches_jax(bits):
    rng = np.random.default_rng(bits)
    g = (rng.normal(size=(4, 6, 16))
         * rng.uniform(1e-4, 10.0, size=(4, 6, 1))).astype(np.float32)
    g[1, 2] = 0.0                                        # an all-zero row
    got = wirefmt.dyn_quantize(T(g), bits).numpy()
    want = np.asarray(jwire.dyn_quantize(jnp.asarray(g), bits))
    m = np.abs(g).max(-1, keepdims=True)
    scale = ((1 << bits) - 1) / (2.0 * np.maximum(m, 1e-12))
    for x in (got, want):       # both on the row's grid, in [-m, m]
        assert (np.abs(x) <= m * (1 + 1e-6)).all()
    np.testing.assert_array_equal(np.round((got + m) * scale),
                                  np.round((want + m) * scale))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)
    assert not got[1, 2].any()
    bf = wirefmt.dyn_quantize(T(g).to(torch.bfloat16), bits)
    assert bf.dtype == torch.bfloat16


def _jax_cut_vjp(wire, mu, lv, eps, cu, cr, cs, bits):
    def f(m, l):
        u, rate, us = jwire.cut_and_ship(None, m, l, link_bits=bits,
                                         wire=wire, eps=jnp.asarray(eps),
                                         backend="reference")
        return (u * cu).sum() + (rate * cr).sum() + (us * cs).sum()
    return jax.value_and_grad(f, argnums=(0, 1))(jnp.asarray(mu),
                                                 jnp.asarray(lv))


def _port_cut_grads(wire, mu, lv, eps, cu, cr, cs, bits):
    m, l = (T(x).requires_grad_() for x in (mu, lv))
    u, rate, us = wirefmt.cut_and_ship(None, m, l, link_bits=bits, wire=wire,
                                       eps=T(eps))
    loss = (u * T(cu)).sum() + (rate * T(cr)).sum() + (us * T(cs)).sum()
    loss.backward()
    return u.detach(), rate.detach(), us.detach(), m.grad, l.grad


@pytest.mark.parametrize("bits", [3, 8])
def test_cut_and_ship_packed_is_dense_and_duplex_matches_jax(bits):
    shape = (2, 40, 16)
    mu, lv, eps = cut_inputs(shape, seed=bits)
    lv = lv * 0.3
    rng = np.random.default_rng(bits + 1)
    cu, cs = (rng.normal(size=shape).astype(np.float32) for _ in range(2))
    cr = rng.normal(size=shape[:-1]).astype(np.float32)
    dense = _port_cut_grads("dense", mu, lv, eps, cu, cr, cs, bits)
    packed = _port_cut_grads("packed", mu, lv, eps, cu, cr, cs, bits)
    for a, b in zip(dense, packed):
        assert torch.equal(a, b)
    assert torch.equal(packed[0], packed[2])             # u_shipped == u
    duplex = _port_cut_grads("packed_duplex", mu, lv, eps, cu, cr, cs, bits)
    for a, b in zip(dense[:3], duplex[:3]):
        assert torch.equal(a, b)                         # forward identical
    assert not torch.equal(dense[3], duplex[3])          # lossy backward
    _, jg = _jax_cut_vjp("packed_duplex", mu, lv, eps, cu, cr, cs, bits)
    for a, b in zip(duplex[3:], jg):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5,
                                   atol=1e-6)
    # the port's duplex backward is the dense one with the error chunk
    # quantized: the straight-through rule by hand
    g_dense = T(cu) + wirefmt.dyn_quantize(T(cs), bits)
    want = tbn.cutlayer_backward(T(mu), T(lv), T(eps), g_dense, T(cr),
                                 link_bits=bits)
    assert torch.equal(duplex[3], want[0]) and torch.equal(duplex[4], want[1])


def test_ship_is_a_lossless_re_encoding_with_straight_through_grads():
    bits = 4
    u = T(_quantized((5, 8, 16), bits, seed=9)).requires_grad_()
    g = T(np.random.default_rng(9).normal(size=(5, 8, 16)).astype(
        np.float32))
    for wire in wirefmt.WIRE_FORMATS:
        out = wirefmt.ship(u, link_bits=bits, wire=wire)
        assert torch.equal(out, u)
        (gu,) = torch.autograd.grad(out, u, g)
        want = wirefmt.dyn_quantize(g, bits) if wire == "packed_duplex" \
            else g
        assert torch.equal(gu, want)
        _, jvjp = jax.vjp(lambda x: jwire.ship(x, link_bits=bits, wire=wire,
                                               backend="reference"),
                          jnp.asarray(u.detach().numpy()))
        np.testing.assert_allclose(gu.numpy(),
                                   np.asarray(jvjp(jnp.asarray(g.numpy()))[0]),
                                   rtol=1e-6, atol=0)


def test_paths_of_later_slices_raise():
    mu, lv, _ = (T(x) for x in cut_inputs((3, 8), seed=0))
    with pytest.raises(NotImplementedError, match="sharded slice"):
        wirefmt.cut_and_ship(None, mu, lv, link_bits=4, wire="packed",
                             axis_name="client")
    with pytest.raises(NotImplementedError, match="sharded slice"):
        wirefmt.ship(mu, link_bits=4, wire="packed", axis_name="client")
    from repro_torch.configs.paper_inl import PaperExperimentConfig
    from repro_torch.core import topology
    with pytest.raises(NotImplementedError, match="sharded slice"):
        topology.graph_cut_and_ship(
            topology.chain(3), PaperExperimentConfig(num_clients=3),
            mu[:, None], lv[:, None], torch.zeros_like(mu)[:, None],
            axis_name="client")


def test_pack_kernels_on_cuda_equal_their_plain_versions(cuda_device):
    """On the H100: cut_fwd_pack's (u, rate) equal cut_fwd's and its lanes
    the plain version's (but on rows at a rounding midpoint); pack and
    unpack_dequant equal their plain versions; unpack(pack(u)) == u.
    Widths {1, 3, 8, 16}, d {7, 64, 96}, fp32 and bf16."""
    for bits in (1, 3, 8, 16):
        for d in (7, 64, 96):
            for dtype in (torch.float32, torch.bfloat16):
                mu, lv, eps = (T(x).to(cuda_device)
                               for x in cut_inputs((37, d), seed=d + bits))
                mu, lv = mu.to(dtype), lv.to(dtype)
                ok = ~near_midpoint(mu.float().cpu().numpy(),
                                    lv.float().cpu().numpy(),
                                    eps.cpu().numpy(), bits).any(-1)
                u, lanes, rate = tbn.cut_fwd_pack(mu, lv, eps, bits=bits,
                                                  mode="sample")
                u1, rate1 = tbn.cut_fwd(mu, lv, eps, bits=bits,
                                        mode="sample")
                pu, plan, _ = ref.cutlayer_pack_fwd_ref(mu, lv, eps, bits,
                                                        "sample")
                torch.cuda.synchronize()
                assert torch.equal(u, u1) and torch.equal(rate, rate1)
                ok_t = torch.from_numpy(ok).to(cuda_device)
                assert torch.equal(lanes.view(torch.int32)[ok_t],
                                   plan.view(torch.int32)[ok_t])
                assert torch.equal(u[ok_t], pu[ok_t])
                back = tbn.unpack(lanes, d=d, bits=bits, dtype=dtype)
                assert torch.equal(back, u)
                if dtype == torch.float32 or bits <= 8:
                    assert torch.equal(
                        tbn.pack(u, bits=bits).view(torch.int32),
                        lanes.view(torch.int32))


def test_unpack_kernel_on_cuda_covers_every_width(cuda_device):
    """On the H100: unpack_dequant at every b in 1..16 (vpw a power of two
    or not, lanes with unused bits), d in {7, 33, 64, 100} (a row's last
    word partly used; row starts off the vector's alignment), R in {1, 7,
    257}, fp32 and bf16, and lanes that start mid-allocation: equal to the
    plain version bit for bit, and unpack(pack(u)) == u where pack takes
    the type (fp32, or bf16 at b <= 8)."""
    rng = np.random.default_rng(16)
    for bits in range(1, 17):
        for d in (7, 33, 64, 100):
            for R in (1, 7, 257):
                idx = torch.from_numpy(rng.integers(
                    0, 1 << bits, size=(R + 1, d))).to(cuda_device)
                # rows 1..R: a lane array that starts one row in
                lanes = ref.pack_indices(idx, bits)[1:]
                for dtype in (torch.float32, torch.bfloat16):
                    back = tbn.unpack(lanes, d=d, bits=bits, dtype=dtype)
                    want = ref.unpack_dequant_ref(lanes, d, bits,
                                                  dtype=dtype)
                    torch.cuda.synchronize()
                    assert back.dtype == dtype and back.shape == (R, d)
                    assert torch.equal(back, want), (bits, d, R, dtype)
                    if dtype == torch.float32 or bits <= 8:
                        again = tbn.unpack(tbn.pack(back, bits=bits), d=d,
                                           bits=bits, dtype=dtype)
                        assert torch.equal(again, back), (bits, d, R, dtype)
