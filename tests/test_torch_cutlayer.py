"""The port's cut layer (repro_torch/kernels) against the JAX reference.

The plain PyTorch version and `ops.cutlayer` on CPU tensors are held
against `cutlayer_fused(impl="pallas", interpret=True)` and
`impl="reference"` over every mode, link widths 1-32 and fp32/bf16 latents,
at a (5, 7, 16) leading shape whose 35 rows are no multiple of the
reference's block_t=16 (it pads; the port's kernel masks).

Bars:
  * b < 32: codewords identical.  The only codewords allowed to differ are
    those whose pre-quantization value lies within 1e-6 of a rounding
    midpoint: XLA's and PyTorch's CPU expf differ in the last ulp on some
    inputs, which can move such a value across the midpoint.
    They are counted, and their rows are left out of the rate comparison.
    The values u = idx / scale - r agree within one ulp of the working
    type, not bit for bit: the port divides (as the CUDA kernel does), but
    XLA's CPU compiler rewrites the reference's division by the constant
    scale into an FMA with its fp32 reciprocal, idx * (1/scale) - r.
  * b = 32 (the identity): u is the unquantized sample, so the same last-ulp
    expf difference shows; within one ulp of the working type.
  * rate: rtol 1e-5, atol 1e-5 (fp32 sums in another order).

The CUDA kernel itself runs only on the card: its test takes the
`cuda_device` fixture (tests/_torch_common.py), which skips with a reason
when no card is present (decided when the test runs, not at import, so
every xdist worker collects the same tests).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import inl_bottleneck as jbn  # noqa: E402
from repro_torch.core import bottleneck, wirefmt  # noqa: E402
from repro_torch.kernels import build, ops, ref  # noqa: E402
from repro_torch.kernels import inl_bottleneck as tbn  # noqa: E402
from _torch_common import cuda_device  # noqa: E402,F401 (fixture)
from _torch_common import cut_inputs as _inputs  # noqa: E402
from _torch_common import near_midpoint  # noqa: E402

MODES = ("sample", "analytic", "none")
BITS = (1, 2, 4, 8, 32)
SHAPE = (5, 7, 16)
TORCH_DT = {"fp32": torch.float32, "bf16": torch.bfloat16}
JAX_DT = {"fp32": jnp.float32, "bf16": jnp.bfloat16}


def codewords(u, bits):
    """Codeword index of each quantized value, recovered in float64."""
    r = ref.QUANT_RANGE
    scale = ((1 << bits) - 1) / (2.0 * r)
    return np.round((np.clip(u.astype(np.float64), -r, r) + r) * scale)


def check_cut(u, rate, u_ref, rate_ref, mu, lv, eps, bits, dt):
    """The bars of the module docstring; returns the midpoint count."""
    a = np.asarray(u, np.float32)
    b = np.asarray(u_ref, np.float32)
    ulp = 2.0 ** -6 if dt == "bf16" else 5e-7        # one ulp at |u| < 4
    bad_rows = np.zeros(a.shape[:-1], bool)
    # a bf16 value pins its codeword only up to 8 bits (half a grid step
    # must exceed half a bf16 ulp at |u| < 4)
    if bits < 32 and (dt == "fp32" or bits <= 8):
        diff = codewords(a, bits) != codewords(b, bits)
        mid = near_midpoint(mu, lv, eps, bits)
        assert not (diff & ~mid).any(), \
            f"{int((diff & ~mid).sum())} codewords differ away from a midpoint"
        bad_rows = diff.any(axis=-1)
        np.testing.assert_allclose(a[~diff], b[~diff], rtol=0, atol=ulp)
    else:
        np.testing.assert_allclose(a, b, rtol=ulp / 4, atol=4e-6)
    np.testing.assert_allclose(np.asarray(rate)[~bad_rows],
                               np.asarray(rate_ref)[~bad_rows],
                               rtol=1e-5, atol=1e-5)
    return int(bad_rows.sum())


@pytest.mark.parametrize("dt", ["fp32", "bf16"])
@pytest.mark.parametrize("bits", BITS)
@pytest.mark.parametrize("mode", MODES)
def test_plain_cutlayer_matches_jax(mode, bits, dt):
    mu, lv, eps = _inputs(SHAPE, seed=bits)
    tmu = torch.from_numpy(mu).to(TORCH_DT[dt])
    tlv = torch.from_numpy(lv).to(TORCH_DT[dt])
    jmu, jlv = jnp.asarray(mu, JAX_DT[dt]), jnp.asarray(lv, JAX_DT[dt])
    # both frameworks round fp32 -> bf16 to nearest even: same inputs
    assert np.array_equal(tmu.float().numpy(), np.asarray(jmu, np.float32))
    mu_in, lv_in = tmu.float().numpy(), tlv.float().numpy()
    u, rate = ops.cutlayer(tmu, tlv, torch.from_numpy(eps), link_bits=bits,
                           rate_estimator=mode)
    assert u.dtype == TORCH_DT[dt] and rate.dtype == torch.float32
    assert u.shape == SHAPE and rate.shape == SHAPE[:-1]
    # the plain version on folded rows is what the CPU dispatch ran
    u2, rate2 = ref.cutlayer_fwd_ref(tmu.reshape(-1, 16), tlv.reshape(-1, 16),
                                     torch.from_numpy(eps).reshape(-1, 16),
                                     bits, mode)
    assert torch.equal(u2.reshape(SHAPE), u)
    assert torch.equal(rate2.reshape(SHAPE[:-1]), rate)
    for impl in ("pallas", "reference"):
        kw = dict(interpret=True, block_t=16) if impl == "pallas" else {}
        ju, jrate = jbn.cutlayer_fused(jmu, jlv, jnp.asarray(eps),
                                       link_bits=bits, rate_estimator=mode,
                                       impl=impl, **kw)
        assert ju.dtype == JAX_DT[dt]
        u_np = u.float().numpy()
        n_mid = check_cut(u_np, rate.numpy(), ju, jrate, mu_in, lv_in, eps,
                          bits, dt)
        print(f"{mode} b={bits} {dt} {impl}: {n_mid} midpoint rows")


def test_dtype_contract_raises_typeerror(monkeypatch):
    mu, lv, eps = (torch.from_numpy(x) for x in _inputs((3, 8)))
    real = tbn.cutlayer_fused
    monkeypatch.setattr(tbn, "cutlayer_fused", lambda *a, **k: (
        real(*a, **k)[0].double(), real(*a, **k)[1]))
    with pytest.raises(TypeError, match="latent dtype"):
        ops.cutlayer(mu, lv, eps)
    monkeypatch.setattr(tbn, "cutlayer_fused", lambda *a, **k: (
        real(*a, **k)[0], real(*a, **k)[1].to(torch.bfloat16)))
    with pytest.raises(TypeError, match="fp32"):
        ops.cutlayer(mu, lv, eps)


def test_unknown_mode_raises_valueerror():
    mu, lv, eps = (torch.from_numpy(x) for x in _inputs((3, 8)))
    with pytest.raises(ValueError, match="rate_estimator"):
        ops.cutlayer(mu, lv, eps, rate_estimator="bogus")


def test_dispatch_is_by_device_without_fallback():
    """CPU tensors take the plain version; anything that is neither all-CPU
    nor all-CUDA raises, and the kernel's launcher refuses CPU tensors."""
    mu, lv, eps = (torch.from_numpy(x) for x in _inputs((3, 8)))
    before = tbn.LAUNCHES["cut_fwd"]
    ops.cutlayer(mu, lv, eps)
    meta = [t.to("meta") for t in (mu, lv, eps)]
    with pytest.raises(ValueError, match="CPU or CUDA"):
        ops.cutlayer(*meta)
    with pytest.raises(ValueError, match="CUDA tensors"):
        tbn.cut_fwd(mu, lv, eps, bits=8, mode="sample")
    assert tbn.LAUNCHES["cut_fwd"] == before     # the plain version ran


def test_unported_paths_raise():
    """The learned prior, the backward and the packed wires are ported; the
    wire's collective over a client axis (the sharded slice) is not yet."""
    mu, lv, eps = (torch.from_numpy(x) for x in _inputs((3, 8)))
    u, rate = ops.cutlayer(mu.requires_grad_(), lv, eps,
                           prior_mu=torch.zeros(8),
                           prior_logvar=torch.zeros(8))
    (rate.sum() + u.sum()).backward()
    assert mu.grad is not None and mu.grad.shape == mu.shape
    for wire in ("packed", "packed_duplex"):
        u, _, shipped = wirefmt.cut_and_ship(None, mu, lv, link_bits=4,
                                             wire=wire)
        assert torch.equal(shipped, u)
        with pytest.raises(NotImplementedError, match="sharded slice"):
            wirefmt.cut_and_ship(None, mu, lv, link_bits=4, wire=wire,
                                 axis_name="client")


def test_fused_sample_rate_eps_from_generator():
    mu, lv, _ = (torch.from_numpy(x) for x in _inputs((5, 4, 8)))
    u0, r0 = bottleneck.fused_sample_rate(None, mu, lv, link_bits=4,
                                          rate_estimator="none")
    assert torch.equal(u0, ref.quantize_value(mu, 4))
    assert torch.equal(r0, torch.zeros(5, 4))
    g = torch.Generator().manual_seed(3)
    u, r = bottleneck.fused_sample_rate(g, mu, lv, link_bits=8)
    eps = torch.randn(mu.shape, generator=torch.Generator().manual_seed(3))
    ue, re = ops.cutlayer(mu, lv, eps, link_bits=8)
    assert torch.equal(u, ue) and torch.equal(r, re)


def test_build_module_finds_sources_and_names_missing_nvcc(monkeypatch,
                                                           tmp_path):
    assert build.sources() == ("cut_bwd", "cut_fwd", "cut_fwd_pack",
                               "cut_prior_bwd", "cut_prior_fwd",
                               "flash_attn_fwd", "pack", "ssd_scan",
                               "unpack_dequant")
    assert str(build.BUILD_DIR).endswith("build/kernels")
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setenv("PATH", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build.nvcc()


def test_cuda_kernel_matches_plain_version(cuda_device):
    """On the card: the kernel against the plain version on the same CUDA
    tensors, every mode, widths 1-32, fp32/bf16, ragged and full rows."""
    for shape in ((5, 64, 64), (5, 7, 64), (5, 4096, 96)):
        for bits in (1, 2, 4, 8, 16, 32):
            for mode in MODES:
                for dt in ("fp32", "bf16"):
                    mu, lv, eps = _inputs(shape, seed=bits)
                    tmu = torch.from_numpy(mu).to(cuda_device, TORCH_DT[dt])
                    tlv = torch.from_numpy(lv).to(cuda_device, TORCH_DT[dt])
                    teps = torch.from_numpy(eps).to(cuda_device)
                    before = tbn.LAUNCHES["cut_fwd"]
                    u, rate = ops.cutlayer(tmu, tlv, teps, link_bits=bits,
                                           rate_estimator=mode)
                    assert tbn.LAUNCHES["cut_fwd"] == before + 1
                    d = shape[-1]
                    pu, prate = ref.cutlayer_fwd_ref(
                        tmu.reshape(-1, d), tlv.reshape(-1, d),
                        teps.reshape(-1, d), bits, mode)
                    torch.cuda.synchronize()
                    check_cut(u.float().cpu().numpy(), rate.cpu().numpy(),
                              pu.reshape(shape).float().cpu().numpy(),
                              prate.reshape(shape[:-1]).cpu().numpy(),
                              tmu.float().cpu().numpy(),
                              tlv.float().cpu().numpy(), eps, bits, dt)
