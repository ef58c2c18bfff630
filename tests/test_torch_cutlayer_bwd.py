"""The port's cut-layer backward and learned-prior cut layer against the JAX
reference's custom VJPs.

The plain backward (`kernels/ref.cutlayer_bwd_ref`,
`cutlayer_prior_bwd_ref`) and the CPU path of both autograd Functions
(`ops.cutlayer`, with and without a prior, under `torch.autograd.grad`) are
held against `jax.vjp` of `cutlayer_fused(impl="reference")` on the same
inputs and cotangents: modes sample / analytic / none, link widths
{2, 8, 32}, fp32 and bf16 latents, ragged rows ((5, 7, 16): 35 rows), and
shared (d,) and per-node (J, d) priors.  The backward is held against the
reference's hand-written VJP, never against torch autograd through the
plain forward: that would differentiate the rounding as zero.

Bars:
  * fp32: atol = rtol = 1e-5, the bar of tests/test_cutlayer_vjp.py.
  * bf16 outputs (dmu, dlv): within one bf16 ulp (rtol 2^-7, atol 1e-5):
    an fp32 result that differs in its last bit between the frameworks can
    round to the neighbouring bf16 value.  (tests/test_cutlayer_vjp.py
    holds the reference's own bf16 gradients to 5e-2.)
  * sample mode at b < 32: rows holding an entry within 1e-6 of a rounding
    midpoint are left out (XLA's and PyTorch's expf and XLA's fma-rewritten
    dequantize differ in the last ulp; see tests/test_torch_cutlayer.py).

The kernels themselves run only on the card: their tests take the
`cuda_device` fixture and skip here.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.kernels import inl_bottleneck as jbn  # noqa: E402
from repro_torch.kernels import build, ops, ref  # noqa: E402
from repro_torch.kernels import inl_bottleneck as tbn  # noqa: E402
from _torch_common import cuda_device  # noqa: E402,F401 (fixture)
from _torch_common import cut_inputs, near_midpoint  # noqa: E402

SHAPE = (5, 7, 16)
BITS = (2, 8, 32)
TORCH_DT = {"fp32": torch.float32, "bf16": torch.bfloat16}
JAX_DT = {"fp32": jnp.float32, "bf16": jnp.bfloat16}


def _case(shape, dt, seed, prior=None):
    """Inputs and cotangents as numpy (rounded to `dt` where they are
    latents), plus the priors: None, "shared" (d,) or "node" (J, d)."""
    mu, lv, eps = cut_inputs(shape, seed)
    rng = np.random.default_rng(seed + 7)
    gu = rng.normal(size=shape).astype(np.float32)
    # rate cotangents of a training step are small (s / B); 0.1 keeps the
    # prior gradients' row sums in the range the 1e-5 bar can resolve
    gr = rng.normal(scale=0.1, size=shape[:-1]).astype(np.float32)
    # round the latents and gu to dt once, so both frameworks see one input
    mu, lv, gu = (torch.from_numpy(x).to(TORCH_DT[dt]).float().numpy()
                  for x in (mu, lv, gu))
    pri = None
    if prior is not None:
        pshape = (shape[-1],) if prior == "shared" else (shape[0], shape[-1])
        pri = (rng.normal(scale=0.5, size=pshape).astype(np.float32),
               rng.uniform(-1.0, 1.0, size=pshape).astype(np.float32))
    return mu, lv, eps, gu, gr, pri


def _jax_vjp(mu, lv, eps, gu, gr, dt, bits, mode, pri=None):
    """(dmu, dlv, deps[, dpmu, dplv]) of the reference's custom VJP."""
    args = [jnp.asarray(mu, JAX_DT[dt]), jnp.asarray(lv, JAX_DT[dt]),
            jnp.asarray(eps)]
    if pri is not None:
        args += [jnp.asarray(pri[0]), jnp.asarray(pri[1])]

    def f(*a):
        kw = {} if pri is None else {"prior_mu": a[3], "prior_logvar": a[4]}
        return jbn.cutlayer_fused(a[0], a[1], a[2], link_bits=bits,
                                  rate_estimator=mode, impl="reference", **kw)
    _, vjp = jax.vjp(f, *args)
    return [np.asarray(g, np.float32)
            for g in vjp((jnp.asarray(gu, JAX_DT[dt]), jnp.asarray(gr)))]


def _torch_grads(mu, lv, eps, gu, gr, dt, bits, mode, pri=None):
    """Gradients through ops.cutlayer's autograd Function on the CPU."""
    ins = [torch.from_numpy(mu).to(TORCH_DT[dt]),
           torch.from_numpy(lv).to(TORCH_DT[dt]), torch.from_numpy(eps)]
    kw = {}
    if pri is not None:
        ins += [torch.from_numpy(pri[0]), torch.from_numpy(pri[1])]
    for t in ins:
        t.requires_grad_(True)
    if pri is not None:
        kw = {"prior_mu": ins[3], "prior_logvar": ins[4]}
    u, rate = ops.cutlayer(*ins[:3], link_bits=bits, rate_estimator=mode,
                           **kw)
    assert u.dtype == TORCH_DT[dt] and rate.dtype == torch.float32
    grads = torch.autograd.grad(
        (u, rate), ins,
        (torch.from_numpy(gu).to(TORCH_DT[dt]), torch.from_numpy(gr)),
        allow_unused=True)
    return [np.zeros(t.shape, np.float32) if g is None
            else g.float().numpy() for g, t in zip(grads, ins)], grads


def _skip_rows(mu, lv, eps, bits, mode):
    """Rows left out of the comparison: a midpoint entry in sample mode."""
    if mode != "sample" or bits >= 32:
        return np.zeros(mu.shape[:-1], bool)
    return near_midpoint(mu, lv, eps, bits).any(axis=-1)


def _assert_close(got, want, dt, keep, name):
    tol = dict(rtol=2.0 ** -7, atol=1e-5) if dt == "bf16" \
        else dict(rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got[keep], want[keep], err_msg=name, **tol)


@pytest.mark.parametrize("dt", ["fp32", "bf16"])
@pytest.mark.parametrize("bits", BITS)
@pytest.mark.parametrize("mode", ["sample", "analytic", "none"])
def test_backward_matches_jax_vjp(mode, bits, dt):
    mu, lv, eps, gu, gr, _ = _case(SHAPE, dt, seed=bits)
    want = _jax_vjp(mu, lv, eps, gu, gr, dt, bits, mode)
    keep = ~_skip_rows(mu, lv, eps, bits, mode)
    got, grads = _torch_grads(mu, lv, eps, gu, gr, dt, bits, mode)
    assert grads[0].dtype == TORCH_DT[dt] and grads[1].dtype == TORCH_DT[dt]
    assert grads[2].dtype == torch.float32
    # the plain backward on folded rows is what the CPU Function ran
    d = SHAPE[-1]
    plain = ref.cutlayer_bwd_ref(
        *(torch.from_numpy(x).reshape(-1, d).to(TORCH_DT[dt])
          for x in (mu, lv)), torch.from_numpy(eps).reshape(-1, d),
        torch.from_numpy(gu).reshape(-1, d).to(TORCH_DT[dt]),
        torch.from_numpy(gr).reshape(-1), bits, mode)
    for name, g, p, w in zip(("dmu", "dlv", "deps"), got, plain, want):
        assert np.array_equal(p.float().numpy().reshape(SHAPE), g), name
        _assert_close(g, w, dt, keep, name)


@pytest.mark.parametrize("dt", ["fp32", "bf16"])
@pytest.mark.parametrize("prior", ["shared", "node"])
@pytest.mark.parametrize("bits", BITS)
@pytest.mark.parametrize("mode", ["sample", "analytic"])
def test_prior_backward_matches_jax_vjp(mode, bits, prior, dt):
    mu, lv, eps, gu, gr, pri = _case(SHAPE, dt, seed=10 + bits, prior=prior)
    want = _jax_vjp(mu, lv, eps, gu, gr, dt, bits, mode, pri)
    keep = ~_skip_rows(mu, lv, eps, bits, mode)
    got, grads = _torch_grads(mu, lv, eps, gu, gr, dt, bits, mode, pri)
    assert [g.dtype for g in grads[3:]] == [torch.float32] * 2
    for name, g, w in zip(("dmu", "dlv", "deps"), got[:3], want[:3]):
        _assert_close(g, w, dt, keep, name)
    if keep.all():
        # the prior gradients sum over every row of a node
        for name, g, w in zip(("dpmu", "dplv"), got[3:], want[3:]):
            np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-5,
                                       err_msg=name)


@pytest.mark.parametrize("prior", ["shared", "node"])
def test_prior_forward_and_plain_backward_match_jax(prior):
    """The plain prior forward and backward on (J, T, d) rows against the
    reference's plain versions, on the reference's saved u."""
    from repro.kernels import ref as jref
    mu, lv, eps, gu, gr, pri = _case(SHAPE, "fp32", seed=3, prior=prior)
    J = 1 if prior == "shared" else SHAPE[0]
    rows = [x.reshape(J, -1, SHAPE[-1]) for x in (mu, lv, eps)]
    pm, pv = (p.reshape(J, SHAPE[-1]) for p in pri)
    for mode in ("sample", "analytic"):
        ju, jrate = jref.cutlayer_prior_fwd_ref(
            *(jnp.asarray(x) for x in (*rows, pm, pv)), 8, mode)
        tu, trate = ref.cutlayer_prior_fwd_ref(
            *(torch.from_numpy(x) for x in (*rows, pm, pv)), 8, mode)
        keep = ~_skip_rows(*rows, 8, "sample")
        np.testing.assert_allclose(tu.numpy()[keep], np.asarray(ju)[keep],
                                   rtol=0, atol=5e-7)
        np.testing.assert_allclose(trate.numpy()[keep],
                                   np.asarray(jrate)[keep],
                                   rtol=1e-5, atol=1e-5)
        jg = jref.cutlayer_prior_bwd_ref(
            *(jnp.asarray(x) for x in (*rows, pm, pv)), ju,
            jnp.asarray(gu.reshape(rows[0].shape)),
            jnp.asarray(gr.reshape(rows[0].shape[:-1])), 8, mode)
        tg = ref.cutlayer_prior_bwd_ref(
            *(torch.from_numpy(x) for x in (*rows, pm, pv)),
            torch.from_numpy(np.array(ju)),
            torch.from_numpy(gu.reshape(rows[0].shape)),
            torch.from_numpy(gr.reshape(rows[0].shape[:-1])), 8, mode)
        for a, b in zip(tg, jg):
            np.testing.assert_allclose(a.numpy(), np.asarray(b),
                                       rtol=1e-5, atol=1e-5)


def test_none_mode_ignores_the_prior():
    """rate_estimator="none" takes the standard kernel: zero rate, no
    gradient reaches the prior (the reference's ops.cutlayer alike)."""
    mu, lv, eps, gu, gr, pri = _case(SHAPE, "fp32", seed=5, prior="node")
    got, grads = _torch_grads(mu, lv, eps, gu, gr, "fp32", 8, "none", pri)
    assert grads[3] is None and grads[4] is None
    want = _jax_vjp(mu, lv, eps, gu, gr, "fp32", 8, "none", pri)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-5)


def test_prior_shape_errors():
    mu, lv, eps = (torch.from_numpy(x) for x in cut_inputs(SHAPE))
    with pytest.raises(ValueError, match="per-node prior J=4"):
        ops.cutlayer(mu, lv, eps, prior_mu=torch.zeros(4, 16),
                     prior_logvar=torch.zeros(4, 16))
    with pytest.raises(ValueError, match="width 16"):
        ops.cutlayer(mu, lv, eps, prior_mu=torch.zeros(8),
                     prior_logvar=torch.zeros(8))


def test_cutlayer_backward_dispatch_matches_plain():
    """The public plain dispatch folds leading axes and runs the plain
    version on CPU tensors, launching nothing."""
    mu, lv, eps, gu, gr, _ = _case(SHAPE, "fp32", seed=2)
    t = [torch.from_numpy(x) for x in (mu, lv, eps, gu, gr)]
    before = dict(tbn.LAUNCHES)
    got = tbn.cutlayer_backward(*t, link_bits=8, rate_estimator="sample")
    want = ref.cutlayer_bwd_ref(*(x.reshape(-1, 16) for x in t[:4]),
                                t[4].reshape(-1), 8, "sample")
    for a, b in zip(got, want):
        assert a.shape == SHAPE and torch.equal(a.reshape(-1, 16), b)
    assert tbn.LAUNCHES == before


def test_kernel_wrappers_raise_on_cpu_tensors():
    mu, lv, eps = (torch.from_numpy(x) for x in cut_inputs((4, 8)))
    gr = torch.zeros(4)
    pm, pv = torch.zeros(1, 8), torch.zeros(1, 8)
    calls = {
        "cut_bwd": lambda: tbn.cut_bwd(mu, lv, eps, mu, gr, bits=8,
                                       mode="sample"),
        "cut_prior_fwd": lambda: tbn.cut_prior_fwd(
            mu[None], lv[None], eps[None], pm, pv, bits=8, mode="sample"),
        "cut_prior_bwd": lambda: tbn.cut_prior_bwd(
            mu[None], lv[None], eps[None], pm, pv, mu[None], mu[None],
            gr[None], mode="sample"),
    }
    before = dict(tbn.LAUNCHES)
    for name, call in calls.items():
        with pytest.raises(ValueError, match="CUDA tensors"):
            call()
    with pytest.raises(ValueError, match="rate_estimator"):
        tbn.cut_prior_fwd(mu[None], lv[None], eps[None], pm, pv, bits=8,
                          mode="none")
    assert tbn.LAUNCHES == before


def test_library_name_hashes_the_shared_headers(tmp_path, monkeypatch):
    """Editing a header of csrc/ renames (so rebuilds) every library."""
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    for p in build.CSRC.iterdir():
        (csrc / p.name).write_bytes(p.read_bytes())
    monkeypatch.setattr(build, "CSRC", csrc)
    before = {n: build._library_path(n) for n in build.sources()}
    assert before == {n: build._library_path(n) for n in build.sources()}
    header = csrc / "cut_common.cuh"
    header.write_text(header.read_text() + "\n// edited\n")
    after = {n: build._library_path(n) for n in build.sources()}
    assert all(after[n] != before[n] for n in before)
    assert all(p.parent == build.BUILD_DIR for p in after.values())


def test_cuda_backward_kernels_match_plain_versions(cuda_device):
    """On the card: cut_bwd, cut_prior_fwd and cut_prior_bwd against their
    plain versions on the same CUDA tensors; the prior backward twice, bit
    for bit, its prior gradients equal to the ordered plain sums bit for
    bit."""
    for shape in ((5, 64, 64), (5, 7, 64)):
        d = shape[-1]
        for bits in (2, 8, 32):
            for dt in ("fp32", "bf16"):
                mu, lv, eps, gu, gr, pri = _case(shape, dt, bits, "node")
                c = [torch.from_numpy(x).to(cuda_device)
                     for x in (mu, lv, eps, gu, gr, *pri)]
                for t in (0, 1, 3):
                    c[t] = c[t].to(TORCH_DT[dt])
                for mode in ("sample", "analytic", "none"):
                    rows = [x.reshape(-1, d) for x in c[:4]]
                    k = tbn.cut_bwd(*rows, c[4].reshape(-1), bits=bits,
                                    mode=mode)
                    p = ref.cutlayer_bwd_ref(*rows, c[4].reshape(-1), bits,
                                             mode)
                    for a, b in zip(k, p):
                        torch.testing.assert_close(a, b, rtol=1e-5,
                                                   atol=1e-6)
                for mode in ("sample", "analytic"):
                    u, rate = tbn.cut_prior_fwd(*c[:3], *c[5:], bits=bits,
                                                mode=mode)
                    pu, prate = ref.cutlayer_prior_fwd_ref(*c[:3], *c[5:],
                                                           bits, mode)
                    torch.testing.assert_close(u, pu, rtol=0, atol=0)
                    torch.testing.assert_close(rate, prate, rtol=1e-5,
                                               atol=1e-5)
                    k1 = tbn.cut_prior_bwd(*c[:3], *c[5:], u, c[3], c[4],
                                           mode=mode)
                    k2 = tbn.cut_prior_bwd(*c[:3], *c[5:], u, c[3], c[4],
                                           mode=mode)
                    assert all(torch.equal(a, b) for a, b in zip(k1, k2))
                    o = ref.cutlayer_prior_bwd_sums_ordered(
                        c[0], c[1], *c[5:], u, c[4], mode)
                    assert torch.equal(k1[3], o[0]) and \
                        torch.equal(k1[4], o[1])
                    p = ref.cutlayer_prior_bwd_ref(*c[:3], *c[5:], u, c[3],
                                                   c[4], bits, mode)
                    for a, b in zip(k1[:3], p[:3]):
                        torch.testing.assert_close(a, b, rtol=1e-5,
                                                   atol=1e-6)
                    for a, b in zip(k1[3:], p[3:]):
                        torch.testing.assert_close(a, b, rtol=1e-5,
                                                   atol=1e-5)


def test_cuda_prior_backward_geometry_repeats_and_graph_replays(cuda_device):
    """On the card: cut_prior_bwd on rows that fill, straddle and overrun
    its 8-row chunks and its ~264-block grid (T in {1, 65, 4097}, J in
    {1, 5}), at an even d (pairs) and an odd one (single columns), fp32 and
    bf16: dpmu, dplv equal the ordered plain sums bit for bit, the per-row
    gradients the plain backward within rtol 1e-5, atol 1e-6; three
    launches identical; one CUDA-graph capture replayed twice identical to
    the eager call (the kernel's counters start every launch from zero)."""
    for J in (1, 5):
        for T in (1, 65, 4097):
            for d in (80, 37):
                for dt in ("fp32", "bf16"):
                    mu, lv, eps, gu, gr, pri = _case((J, T, d), dt, T + d,
                                                     "node")
                    c = [torch.from_numpy(x).to(cuda_device)
                         for x in (mu, lv, eps, gu, gr, *pri)]
                    for t in (0, 1, 3):
                        c[t] = c[t].to(TORCH_DT[dt])
                    for mode in ("sample", "analytic"):
                        u, _ = tbn.cut_prior_fwd(*c[:3], *c[5:], bits=8,
                                                 mode=mode)

                        def call():
                            return tbn.cut_prior_bwd(*c[:3], *c[5:], u, c[3],
                                                     c[4], mode=mode)
                        runs = [call() for _ in range(3)]
                        torch.cuda.synchronize()
                        for k in runs[1:]:
                            assert all(torch.equal(a, b)
                                       for a, b in zip(runs[0], k))
                        o = ref.cutlayer_prior_bwd_sums_ordered(
                            c[0], c[1], *c[5:], u, c[4], mode)
                        assert torch.equal(runs[0][3], o[0])
                        assert torch.equal(runs[0][4], o[1])
                        p = ref.cutlayer_prior_bwd_ref(
                            *c[:3], *c[5:], u, c[3], c[4], 8, mode)
                        for a, b in zip(runs[0][:3], p[:3]):
                            torch.testing.assert_close(a, b, rtol=1e-5,
                                                       atol=1e-6)
                    graph = torch.cuda.CUDAGraph()
                    with torch.cuda.graph(graph):
                        captured = call()
                    for _ in range(2):
                        for t in captured:
                            t.fill_(float("nan"))
                        graph.replay()
                        torch.cuda.synchronize()
                        assert all(torch.equal(a, b)
                                   for a, b in zip(captured, runs[0]))
