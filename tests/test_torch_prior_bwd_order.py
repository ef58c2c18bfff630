"""The learned-prior backward's prior gradients summed in the CUDA kernel's
order (`kernels/ref.cutlayer_prior_bwd_sums_ordered`) against the JAX
reference's custom VJP and against the port's plain backward.

On the card the kernel (`csrc/cut_prior_bwd.cu`) must equal the ordered
function bit for bit (tests/test_torch_cutlayer_bwd.py, chip_smoke.py);
here, on the CPU, the ordered function is held to the reference:
  * dpmu, dplv of `jax.vjp` of `cutlayer_fused(impl="reference")` with the
    prior, on the reference's own saved u, and of `cutlayer_prior_bwd_ref`
    on the same u, within chip_smoke.py's bar for sums: rtol/atol 1e-5, or,
    where the terms cancel, 1e-5 of the sum of their absolute values (two
    fp32 orders of one sum differ by that much and no more);
  * modes sample / analytic, shared (d,) and per-node (J, d) priors, J in
    {1, 5} nodes of T in {1, 7, 63, 64, 65, 4097} rows, d = 80 (a full
    64-column tile and a part one): rows that fill, straddle and overrun
    the kernel's 8-row chunks and its grid of about 264 blocks.
Its chunk and tile sizes are the .cu file's; the first test reads them
from it.
"""
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.kernels import inl_bottleneck as jbn  # noqa: E402
from repro_torch.kernels import build, ref  # noqa: E402
from _torch_common import cut_inputs  # noqa: E402

D, BITS = 80, 8
SUM_TOL = 1e-5


def test_ordered_sums_use_the_kernels_geometry():
    src = (build.CSRC / "cut_prior_bwd.cu").read_text()
    consts = dict(re.findall(r"constexpr int (k\w+) = (\d+);", src))
    assert {k: int(v) for k, v in consts.items()
            if k in ("kWarps", "kTileCols")} == {
        "kWarps": ref.PRIOR_BWD_ROWS, "kTileCols": ref.PRIOR_BWD_TILE}
    # small calls spread over tens of blocks, large ones over ~264
    assert ref.prior_bwd_blocks(5, 64, 64) * 5 == 40
    assert ref.prior_bwd_blocks(4, 65536, 64) * 4 == 264
    assert ref.prior_bwd_blocks(1, 1, 80) == 1


def _sum_scales(mu, lv, u, pm, pv, gr, mode):
    """float64 sums of |terms| per (node, column) of dpmu and dplv (as
    chip_smoke.sum_scales)."""
    m, l, q = (x.astype(np.float64) for x in (mu, lv, u))
    p, v = pm.astype(np.float64)[:, None], pv.astype(np.float64)[:, None]
    g = np.abs(gr.astype(np.float64))[..., None]
    if mode == "sample":
        wq = (q - p) * np.exp(-v)
        return ((g * np.abs(wq)).sum(1),
                0.5 * (g.sum(1) + (g * np.abs(wq * (q - p))).sum(1)))
    dm = (m - p) * np.exp(-v)
    return ((g * np.abs(dm)).sum(1),
            0.5 * (g.sum(1) + (g * np.exp(l - v)).sum(1)
                   + (g * np.abs(dm * (m - p))).sum(1)))


def _sums_close(got, want, scale, name):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    diff = np.abs(got - want)
    ok = (diff <= SUM_TOL + SUM_TOL * np.abs(want)) | (diff <= SUM_TOL
                                                        * scale)
    assert ok.all(), (name, diff[~ok][:4], want[~ok][:4], scale[~ok][:4])


@pytest.mark.parametrize("J", [1, 5])
@pytest.mark.parametrize("T", [1, 7, 63, 64, 65, 4097])
@pytest.mark.parametrize("prior", ["shared", "node"])
@pytest.mark.parametrize("mode", ["sample", "analytic"])
def test_ordered_prior_sums_match_jax_and_the_plain_backward(mode, prior, T,
                                                             J):
    mu, lv, eps = cut_inputs((J, T, D), seed=T + J)
    rng = np.random.default_rng(T * 7 + J)
    gu = rng.normal(size=(J, T, D)).astype(np.float32)
    gr = rng.normal(scale=0.1, size=(J, T)).astype(np.float32)
    P = 1 if prior == "shared" else J           # the kernel's nodes
    pm = rng.normal(scale=0.5, size=(P, D)).astype(np.float32)
    pv = rng.uniform(-1.0, 1.0, size=(P, D)).astype(np.float32)

    def f(mu, lv, eps, pm, pv):
        return jbn.cutlayer_fused(mu, lv, eps, link_bits=BITS,
                                  rate_estimator=mode, impl="reference",
                                  prior_mu=pm, prior_logvar=pv)
    jp = [jnp.asarray(pm[0] if prior == "shared" else pm),
          jnp.asarray(pv[0] if prior == "shared" else pv)]
    (u, _), vjp = jax.vjp(f, *(jnp.asarray(x) for x in (mu, lv, eps)), *jp)
    want = [np.asarray(g).reshape(P, D)
            for g in vjp((jnp.asarray(gu), jnp.asarray(gr)))[3:]]
    u = np.asarray(u)
    # the kernel's view: P nodes of J * T / P rows
    rows = [x.reshape(P, -1, D) for x in (mu, lv, eps, u, gu)]
    grow = gr.reshape(P, -1)
    t = [torch.from_numpy(np.array(x, np.float32))
         for x in (*rows, pm, pv, grow)]
    got = ref.cutlayer_prior_bwd_sums_ordered(t[0], t[1], t[5], t[6], t[3],
                                              t[7], mode)
    plain = ref.cutlayer_prior_bwd_ref(*t[:3], t[5], t[6], t[3], t[4], t[7],
                                       32, mode)[3:]
    assert all(g.dtype == torch.float32 and g.shape == (P, D) for g in got)
    scales = _sum_scales(rows[0], rows[1], rows[3], pm, pv, grow, mode)
    for name, g, w, p, sc in zip(("dpmu", "dplv"), got, want, plain,
                                 scales):
        _sums_close(g.numpy(), w, sc, f"{name} vs jax")
        _sums_close(g.numpy(), p.numpy(), sc, f"{name} vs plain")
